"""A run of one cell, reduced to the result line.

``run_cell`` drives the window (``loop``), reads the traced stretch
(``devtrace``), decides ``correct`` (``check``, after the program's state
is freed) and has each metric's reader (``servebench/metrics/<name>.py``)
reduce the samples. ``emit`` prints the compared numbers on standard
error and the JSON line on standard output, last.
"""
from __future__ import annotations

import json
import sys
import time
from types import SimpleNamespace

import torch

from benchlib import check, cost, loop, spec


def _context(root, res, dtrace, hp, kind) -> SimpleNamespace:
    """What a metric reader may read."""
    return SimpleNamespace(
        setup_s=res.setup_s, w0=res.w0, w1=res.w1, window_s=res.w1 - res.w0,
        requests=res.requests, all_reqs=res.all_reqs,
        counters_window=res.counters_window, counters_sub=res.counters_sub,
        sub=res.sub, profiled=res.profiled,
        counters_outside=res.counters_outside,
        steps_sub=res.steps_sub, step_s=res.step_s,
        step_ends=res.step_ends, trace=dtrace, hp=hp,
        peaks=spec.peaks(root, kind))


def _new_tokens(res, lo, hi) -> float:
    """The prompt tokens the traffic says the prefills in (lo, hi] compute,
    placed as ``cost.prefills_in`` places them: printed beside the
    engine's count, the cross-check of what the prefill metrics count."""
    return sum(w * n for _, n, w in cost.prefills_in(
        res.all_reqs, res.step_ends, lo, hi))


def run_cell(root, cell, *, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False) -> dict:
    hp = spec.hparams(cell.config)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    res = loop.run(cell, seed, seconds, trace, device, t_start)
    dtrace = res.dtrace

    limits = cell.params["check"]
    n_models = int(cell.config["engine"]["decoders"])
    reqs = check.sample(res.requests, int(limits["requests"]), n_models,
                        seed)
    scored = None
    t_ref = time.perf_counter()
    if reqs:
        scored = check.score(spec.reference_module(root, cell.config), hp,
                             res.weights, reqs,
                             int(cell.config["engine"]["first_token"]),
                             control=control)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ref_s = time.perf_counter() - t_ref
    correct, checks = check.verdict(scored, limits, res.requests)

    ctx = _context(root, res, dtrace, hp, kind)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = spec.metric_reader(root, m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else "cpu",
           "kind": kind, "count": int(cell.entry["chips"]),
           "memory_peak_bytes": res.memory_peak_bytes}
    out = {"correct": bool(correct),
           "attempted": len(res.requests),
           "failed": sum(1 for r in res.requests if r.failed),
           "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = dtrace.busy_s if dtrace else 0.0
        dev["window_s"] = dtrace.window_s if dtrace else (
            res.sub[1] - res.sub[0] if res.sub else 0.0)
        if dtrace:
            out["breakdown"] = {"device_ops": dtrace.ops,
                                "idle_gaps": dtrace.idle_gaps}
    c = res.counters_window
    out["run"] = {"seed": seed, "seconds": seconds, "steps": res.steps,
                  "window_s": res.w1 - res.w0,
                  "reference_s": ref_s,
                  "traced_steps": len(res.steps_sub),
                  "stretch_s": (res.sub[1] - res.sub[0]) if res.sub else None,
                  "reused": c["prefill_tokens_reused"],
                  "reused_expected": res.expected_reused,
                  "computed": c["prefill_tokens_computed"],
                  "computed_expected": _new_tokens(res, res.w0, res.w1),
                  "sampled": [{"n": len(r.call.prompt),
                               "served": len(r.tokens),
                               "model": r.call.model} for r in reqs]}
    if scored is not None:
        for key in ("gaps", "max_gap", "argmax_match", "control_gap",
                    "control_gaps"):
            if key in scored:
                out["run"][key] = scored[key]
    if res.sub:
        out["run"]["stretch_computed"] = res.counters_sub[
            "prefill_tokens_computed"]
        out["run"]["stretch_computed_expected"] = _new_tokens(res, *res.sub)
    if dtrace:
        out["run"]["device_s_by_class"] = dtrace.class_s
        out["run"]["longest_gap_s"] = dtrace.longest_gap_s
    if trace:
        out["run"]["trace_tries"] = res.trace_tries
    if control:
        out["control_correct"], out["control_checks"] = \
            check.control_verdict(scored, limits, res.requests)
    out["checks"] = checks
    return out


def emit(out: dict) -> None:
    """The compared numbers as the last lines of standard error, then the
    result as the last line of standard output (``checks`` its last
    key)."""
    checks = out.pop("checks")
    out["checks"] = checks
    run = out["run"]
    print(f"servebench: prefill tokens reused {run['reused']}, the "
          f"traffic's count {run['reused_expected']}; computed "
          f"{run['computed']}, the traffic's {run['computed_expected']:.0f}",
          file=sys.stderr)
    for name, c in checks.items():
        bound = " ".join(f"{k} {v}" for k, v in c.items() if k != "value")
        print(f"check {name} {c['value']} {bound}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
