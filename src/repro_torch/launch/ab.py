"""A/B runs of ``chip_smoke.py`` from several checkouts on one card.

    PYTHONPATH=src python -m repro_torch.launch.ab [--logs DIR] TREE [TREE ...]

Each TREE is a checkout of the repository (``.`` for this one, or a copy
unpacked with ``git archive`` into a git-ignored directory). The trees run
one after another in the order given, so ``parent . . parent`` brackets the
change with its parent and two versions are only ever compared on one card
in one sitting. Each run's whole output goes to ``DIR/ab_<i>.log`` (default
``build/ab``); the lines that carry the build, the kernels' times at the
main path's shapes and the main path's turns are printed, tagged with the
run's index. Exits non-zero if any run did.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

KEEP = ("[build]", "[paged_decode] main shape", "[paged_write] Llama fold",
        "[main] turn", "[main] launches", '{"kernels"', "Traceback",
        "Error")


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--logs", default="build/ab")
    ap.add_argument("trees", nargs="+")
    args = ap.parse_args(argv)
    logs = Path(args.logs)
    logs.mkdir(parents=True, exist_ok=True)
    rcs = []
    for i, tree in enumerate(args.trees):
        log = logs / f"ab_{i}.log"
        with open(log, "w") as f:
            rc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree,
                                stdout=f, stderr=subprocess.STDOUT).returncode
        rcs.append(rc)
        print(f"=== run {i}: {tree} exit {rc} (log {log})", flush=True)
        for line in log.read_text().splitlines():
            if line.startswith(KEEP) or any(k in line for k in KEEP[-2:]):
                print(f"[{i}] {line[:600]}", flush=True)
    return 0 if all(rc == 0 for rc in rcs) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
