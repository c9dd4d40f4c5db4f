"""Checked-in baseline of accepted findings.

The port's baseline (``.analysis-baseline-torch.json`` at the repo root,
beside the reference's ``.analysis-baseline.json``) records findings
that are *intentional* — each entry carries the finding's fingerprint plus a
one-line justification. The CLI subtracts baselined findings from its output
and exits 0; anything new fails the run. Fingerprints hash the rule + path +
enclosing function + normalized source line (not line numbers), so the
baseline survives unrelated edits; if the offending line itself changes, the
entry goes stale and the finding resurfaces — which is the desired behavior,
since the justification was written for the old code.
"""
from __future__ import annotations

import json
import os

from repro_torch.analysis.core import Finding

BASELINE_VERSION = 1
DEFAULT_BASELINE = ".analysis-baseline-torch.json"


def load_baseline(path: str) -> dict[str, dict]:
    """fingerprint -> entry dict. Missing file is an empty baseline."""
    if not os.path.isfile(path):
        return {}
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or data.get("version") != BASELINE_VERSION:
        raise ValueError(f"unsupported baseline format in {path!r} "
                         f"(want version={BASELINE_VERSION})")
    out = {}
    for entry in data.get("entries", []):
        out[entry["fingerprint"]] = entry
    return out


def save_baseline(path: str, findings: list[Finding],
                  notes: dict[str, str] | None = None) -> None:
    """Write ``findings`` as the new baseline. ``notes`` maps fingerprints
    to justifications; entries without one get a TODO marker so review
    catches them."""
    notes = notes or {}
    entries = [{
        "fingerprint": f.fingerprint,
        "rule": f.rule,
        "path": f.path,
        "func": f.func,
        "line_text": f.line_text,
        "note": notes.get(f.fingerprint, "TODO: justify this baseline entry"),
    } for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule))]
    payload = {"version": BASELINE_VERSION, "entries": entries}
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2)
        f.write("\n")


def apply_baseline(findings: list[Finding], baseline: dict[str, dict]):
    """Split findings into (new, accepted) and report stale baseline
    fingerprints that matched nothing this run."""
    new, accepted = [], []
    hit: set[str] = set()
    for f in findings:
        if f.fingerprint in baseline:
            accepted.append(f)
            hit.add(f.fingerprint)
        else:
            new.append(f)
    stale = [e for fp, e in baseline.items() if fp not in hit]
    return new, accepted, stale
