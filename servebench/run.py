"""Run one cell of the port's benchmark once and print its result line.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``servebench/``
and the port (``src/repro_torch``); it needs a CUDA card. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compared, beside its limit (also the last lines of standard error).
See ``servebench/README.md``.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names the run must not load (compared whole: the
#: port's ``repro_torch`` is not the JAX package ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: build and kernel caches, fixed paths inside the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "build/triton",
              "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TORCHINDUCTOR_CACHE_DIR": "build/inductor",
              "CUDA_CACHE_PATH": "build/cuda_cache"}
#: the loop is host-paced Python: one intra-op thread keeps idle pool
#: threads from taking cores from it
THREADS = "1"


def _env() -> None:
    for key, rel in CACHE_DIRS.items():
        os.environ[key] = str(ROOT / rel)
    os.environ.setdefault("USE_FLAX", "0")
    for key in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[key] = THREADS
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _power_limit() -> str | None:
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def main(argv=None) -> int:
    _env()
    args = _args(argv)
    import torch
    from benchlib import spec
    cell = spec.load_cell(ROOT, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"servebench: the cell needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(int(THREADS))
    from benchlib import harness
    res = harness.run_cell(ROOT, cell, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace),
                           device=torch.device("cuda", 0), t_start=T_START)
    res["card"] = {"name": torch.cuda.get_device_name(0),
                   "nvidia_smi": _power_limit()}
    bad = forbidden_modules()
    if bad:
        print(f"servebench: the run loaded {bad}; nothing it runs may load "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    harness.emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
