"""The readings a cell's correctness limit is set from, on the card.

    python3 servebench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control]

Runs the cell once per seed in this one process (the set-up is paid per
seed; the kernels load once) and prints one JSON line per seed: the
program's widest gap over the sampled served tokens (the lower reading)
and, with ``--control``, the control's (the reference in float8 e4m3 at
the same positions; the upper reading), judged by the cell's own limit as
the program is: ``control_correct`` has to come out false. The
benchmark's runs never run the control. See ``servebench/README.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run  # noqa: E402  (servebench/run.py: environment and paths)


def main(argv=None) -> int:
    run._env()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from benchlib import harness, spec
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(run.ROOT, args.workload)
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(run.ROOT, cell, seed=seed,
                               seconds=args.seconds, trace=False,
                               device=torch.device("cuda", 0), t_start=t0,
                               control=args.control)
        r = out["run"]
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": out["correct"],
                          "control_correct": out.get("control_correct"),
                          "max_gap": r.get("max_gap"),
                          "gaps": r.get("gaps"),
                          "argmax_match": r.get("argmax_match"),
                          "control_gap": r.get("control_gap"),
                          "control_gaps": r.get("control_gaps"),
                          "sampled": r["sampled"],
                          "metrics": out["metrics"]}), flush=True)
        del out
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
