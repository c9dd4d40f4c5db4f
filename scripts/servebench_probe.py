"""``servebench/run.py`` with what an untraced run's line leaves out.

    python3 scripts/servebench_probe.py [--metrics-off] [--no-mirror] \\
        --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (an older one too: what its program
lacks reads as None). Besides the run's own result it prints, in the
result's ``run`` record, the per-layer readings over the window's
unprofiled steps that an untraced run leaves out (``engine.step_ms`` and
the span metrics, ``untraced``) and each span's own time a step by name
(``span_self_ms_per_step``). ``--metrics-off`` builds the engine with its
metrics switched off (no spans); ``--no-mirror`` keeps the spans out of
the profiler's trace. It needs a CUDA card, as ``run.py`` does.
"""
import importlib.util
import sys
from types import SimpleNamespace

NAMES = ("engine.step_ms", "sched.host_ms", "model.decode_host_ms",
         "model.chunk_host_ms", "engine.device_wait_ms",
         "engine.decode_pad_pct", "sched.queue_wait_p95_s",
         "model.decode_graph_pct")


def _self_per_step(res):
    """Each step span's and its descendants' own time by name, summed over
    the window's unprofiled steps, over their count, in ms; the spans a
    step and the request spans a step."""
    try:
        from repro_torch.serving import metrics as M
    except ImportError:
        return None
    if not hasattr(M, "spans"):
        return None
    got = M.spans()
    p0, p1 = res.profiled if res.profiled else (res.w1, res.w1)
    steps = {s.index for s in got if s.name == "engine.step"
             and res.w0 < s.start_ns / 1e9 <= res.w1
             and (s.end_ns / 1e9 <= p0 or s.start_ns / 1e9 >= p1)}
    if not steps:
        return None
    parent = {s.index: s.parent for s in got}
    keep = []
    for s in got:
        i = s.index
        while i >= 0 and i not in steps:
            i = parent.get(i, -1)
        if i >= 0:
            keep.append(s)
    reqs = sum(1 for s in got if s.name.startswith("req")
               and res.w0 < s.start_ns / 1e9 <= res.w1)
    window_steps = sum(1 for s in got if s.name == "engine.step"
                       and res.w0 < s.start_ns / 1e9 <= res.w1)
    return {"self_ms": {k: v / 1e6 / len(steps)
                        for k, v in sorted(M.self_ns(keep).items())},
            "step_spans_per_step": len(keep) / len(steps),
            "request_spans_per_step": reqs / max(window_steps, 1)}


def main(argv) -> int:
    off = "--metrics-off" in argv
    no_mirror = "--no-mirror" in argv
    argv = [a for a in argv if a not in ("--metrics-off", "--no-mirror")]
    spec_ = importlib.util.spec_from_file_location("sb_run",
                                                   "servebench/run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    run._env()
    from benchlib import harness, loop, spec
    if no_mirror:
        from repro_torch.serving import metrics as M
        M.SPANS._profiling = None
    if off:
        from repro_torch.serving import engine as E
        init = E.LocalDisaggEngine.__init__

        def init_off(self, *a, **kw):
            kw["metrics"] = False
            init(self, *a, **kw)
        E.LocalDisaggEngine.__init__ = init_off

    got = {}
    run_loop, emit = loop.run, harness.emit

    def capture(*a, **kw):
        got["res"] = run_loop(*a, **kw)
        return got["res"]

    def emit_more(out):
        res = got["res"]
        ctx = SimpleNamespace(w0=res.w0, w1=res.w1, profiled=res.profiled,
                              step_s=res.step_s)
        out["run"]["metrics_on"] = not off
        out["run"]["untraced"] = {}
        for n in NAMES:
            try:
                v = spec.metric_reader(run.ROOT, n)(ctx)
            except spec.SpecError:           # a checkout without the file
                v = None
            out["run"]["untraced"][n] = v
        out["run"]["span_self_ms_per_step"] = _self_per_step(res)
        emit(out)

    loop.run, harness.emit = capture, emit_more
    return run.main(argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
