"""``python -m repro_torch.analysis <paths>`` — run the serving-invariant rules.

Exit codes: 0 clean (modulo baseline), 1 new findings, 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from repro_torch.analysis.baseline import (DEFAULT_BASELINE, apply_baseline,
                                           load_baseline, save_baseline)
from repro_torch.analysis.core import analyze_paths
from repro_torch.analysis.rules import ALL_RULES, RULES_BY_ID


def _summary(findings) -> dict:
    by_rule: dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return dict(sorted(by_rule.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Serving-invariant static analyzer for the port's "
                    "torch code (rules RPR001-RPR007; see README).")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to scan (default: src)")
    ap.add_argument("--root", default=".",
                    help="repo root paths are resolved against (default: .)")
    ap.add_argument("--baseline", default=None, metavar="FILE",
                    help=f"baseline JSON of accepted findings "
                         f"(default: <root>/{DEFAULT_BASELINE} if present)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept all current "
                         "findings (preserves existing notes)")
    ap.add_argument("--json", default=None, metavar="FILE", dest="json_out",
                    help="also write findings as JSON ('-' for stdout)")
    ap.add_argument("--rules", default=None, metavar="IDS",
                    help="comma-separated rule ids to run (default: all)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return 0 if e.code in (0, None) else 2

    root = os.path.abspath(args.root)
    rules = ALL_RULES
    if args.rules:
        ids = [r.strip().upper() for r in args.rules.split(",") if r.strip()]
        unknown = [i for i in ids if i not in RULES_BY_ID]
        if unknown:
            print(f"error: unknown rule id(s): {', '.join(unknown)} "
                  f"(have: {', '.join(RULES_BY_ID)})", file=sys.stderr)
            return 2
        rules = [RULES_BY_ID[i] for i in ids]

    for p in args.paths:
        ap_path = p if os.path.isabs(p) else os.path.join(root, p)
        if not os.path.exists(ap_path):
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    findings = analyze_paths(args.paths, root, rules)

    baseline_path = args.baseline
    if baseline_path is None:
        candidate = os.path.join(root, DEFAULT_BASELINE)
        baseline_path = candidate if os.path.isfile(candidate) else None
    elif not os.path.isabs(baseline_path):
        baseline_path = os.path.join(root, baseline_path)

    if args.update_baseline:
        target = baseline_path or os.path.join(root, DEFAULT_BASELINE)
        notes = {}
        if os.path.isfile(target):
            try:
                notes = {fp: e.get("note", "")
                         for fp, e in load_baseline(target).items()}
            except ValueError:
                pass
        save_baseline(target, findings, notes)
        print(f"baseline updated: {len(findings)} finding(s) accepted in "
              f"{os.path.relpath(target, root)}")
        return 0

    baseline = {}
    if baseline_path:
        try:
            baseline = load_baseline(baseline_path)
        except (ValueError, json.JSONDecodeError, KeyError) as e:
            print(f"error: bad baseline {baseline_path}: {e}",
                  file=sys.stderr)
            return 2
    new, accepted, stale = apply_baseline(findings, baseline)

    if args.json_out:
        payload = {
            "version": 1,
            "findings": [dict(f.as_dict(),
                              baselined=f.fingerprint in baseline)
                         for f in findings],
            "summary": {
                "total": len(findings), "new": len(new),
                "baselined": len(accepted), "stale_baseline": len(stale),
                "by_rule": _summary(findings),
            },
        }
        text = json.dumps(payload, indent=2)
        if args.json_out == "-":
            print(text)
        else:
            out = args.json_out if os.path.isabs(args.json_out) \
                else os.path.join(root, args.json_out)
            with open(out, "w", encoding="utf-8") as f:
                f.write(text + "\n")

    for f in new:
        print(f.render())
    for e in stale:
        print(f"warning: stale baseline entry {e['fingerprint']} "
              f"({e['rule']} {e['path']}) matched nothing — remove it or "
              f"re-run with --update-baseline", file=sys.stderr)
    if new:
        print(f"\n{len(new)} new finding(s) "
              f"({len(accepted)} baselined, {len(stale)} stale baseline "
              f"entr{'y' if len(stale) == 1 else 'ies'}).")
        return 1
    if findings:
        extra = f", {len(stale)} stale" if stale else ""
        print(f"clean: 0 new findings ({len(accepted)} baselined{extra}).")
    else:
        print("clean: 0 findings.")
    return 0
