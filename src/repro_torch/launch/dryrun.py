"""Sharded dry run: trace every (arch x input shape x mesh) combo.

The counterpart of ``repro.launch.dryrun``, which lowers and compiles each
combo for 256 or 512 host-platform devices. Here, for each combo:
  1. the production mesh (``launch/mesh.py``: (32, 8) H100s, or
     (2, 32, 8)) over a fake process group of 256 or 512 ranks;
  2. the step and its shape-only arguments (``launch/steps.build``) laid
     out as fake DTensors (``FakeTensorMode``: no number, no allocation);
  3. one run of the step on them, under ``implicit_replication`` and
     ``launch.commanalysis.StepRecorder``;
  4. per device: memory (arguments and outputs from local shard shapes,
     temp as the peak of live temporaries beyond the arguments, alias as
     the outputs that are arguments rewritten in place, no generated code),
     flops, collective bytes, and the trace's seconds (``lower_s``), to
     JSONL.
No device is touched: it is analysis, not a measurement. Resumable: combos
already in the output file are skipped.

Usage:
  python -m repro_torch.launch.dryrun                    # all combos, (32, 8)
  python -m repro_torch.launch.dryrun --multi-pod        # all combos, (2, 32, 8)
  python -m repro_torch.launch.dryrun --arch gemma2-27b --shape decode_32k
  python -m repro_torch.launch.dryrun --single-device --out F   # one device
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

from repro_torch.configs.base import ASSIGNED, INPUT_SHAPES, get_config
from repro_torch.launch.commanalysis import StepRecorder, collective_bytes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.sharding import distribute
from repro_torch.launch.steps import build, set_hooks
from repro_torch.params import tree_leaves, tree_map

SKIP_LONG = "long_500k requires sub-quadratic attention (DESIGN.md §4)"
MEMORY_KEYS = ("argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "generated_code_size_in_bytes")


def combos(archs, shapes):
    for a in archs:
        cfg = get_config(a)
        for s in shapes:
            if s == "long_500k" and not cfg.long_context_ok:
                yield a, s, SKIP_LONG
            else:
                yield a, s, None


def _locals(tree) -> list:
    """Each rank-0 local tensor of a tree of (D)Tensors, once."""
    import torch
    from torch.distributed.tensor import DTensor
    out, seen = [], set()
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = t._local_tensor if isinstance(t, DTensor) else t
        if id(t) not in seen:
            seen.add(id(t))
            out.append(t)
    return out


def _bytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def trace(cfg, shape_name: str, mesh=None) -> dict:
    """Run one step of ``cfg`` at ``shape_name`` on fake tensors, laid out
    on ``mesh`` (one device without one), and return ``{"memory", "cost":
    {"flops"}, "collectives", "lower_s"}``, every figure per device."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.perf_counter()
    b = build(cfg, shape_name, mesh)
    try:
        with FakeTensorMode(allow_non_fake_inputs=True):
            if mesh is None:
                args = tree_map(
                    lambda t: None if t is None
                    else torch.empty(t.shape, dtype=t.dtype), b["args"])
                ctx = contextlib.nullcontext()
            else:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                args = distribute(b["args"], b["placements"], mesh)
                ctx = implicit_replication()
            arg_ts = _locals(args)
            rec = StepRecorder(exclude=arg_ts, sharded=mesh is not None)
            with ctx, rec:
                out = b["fn"](*args)
            out_ts = _locals(out)
    finally:
        set_hooks()                           # the models' hooks back to None
    arg_ids = {t.untyped_storage()._cdata for t in arg_ts}
    memory = dict(zip(MEMORY_KEYS, (
        _bytes(arg_ts), _bytes(out_ts), rec.peak_bytes,
        _bytes(t for t in out_ts if t.untyped_storage()._cdata in arg_ids),
        0)))
    return {"memory": memory, "cost": {"flops": float(rec.flops)},
            "collectives": collective_bytes(rec.records),
            "lower_s": round(time.perf_counter() - t0, 1)}


def run_one(arch: str, shape: str, multi_pod: bool,
            single: bool = False) -> dict:
    """One combo's record on a production mesh, or on one device (mesh
    "1") with ``single``."""
    mesh = None if single else make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": shape,
           "mesh": "1" if single else "x".join(map(str, mesh.shape)),
           "chips": 1 if single else mesh.size()}
    rec.update(trace(get_config(arch), shape, mesh))
    return rec


def _where(exc) -> str:
    """The innermost frame of the port's models (else of the port) that
    the exception passed through, as ``file:line in function``."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename]
    inner = [f for f in frames if "repro_torch/models" in f.filename] \
        or frames
    if not inner:
        return ""
    f = inner[-1]
    return (f"{f.filename[f.filename.index('repro_torch'):]}:{f.lineno} "
            f"in {f.name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-device", action="store_true",
                    help="trace on one device (mesh \"1\"), the figures a "
                         "sharded record's flops x chips must cover")
    ap.add_argument("--out", default="results/torch_dryrun.jsonl")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ASSIGNED
    shapes = [args.shape] if args.shape else list(INPUT_SHAPES)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)

    done = set()
    if os.path.exists(args.out) and not args.force:
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if "error" not in r:
                    done.add((r["arch"], r["shape"], r["mesh"]))

    mesh_tag = "1" if args.single_device else \
        "2x32x8" if args.multi_pod else "32x8"
    n_ok = n_skip = n_fail = 0
    with open(args.out, "a") as f:
        for arch, shape, skip in combos(archs, shapes):
            if (arch, shape, mesh_tag) in done:
                print(f"[dryrun] {arch} x {shape} x {mesh_tag}: cached")
                n_ok += 1
                continue
            if skip:
                print(f"[dryrun] {arch} x {shape}: SKIP ({skip})")
                f.write(json.dumps({"arch": arch, "shape": shape,
                                    "mesh": mesh_tag, "skipped": skip}) + "\n")
                f.flush()
                n_skip += 1
                continue
            print(f"[dryrun] {arch} x {shape} x {mesh_tag} ...", flush=True)
            try:
                rec = run_one(arch, shape, args.multi_pod,
                              args.single_device)
                n_ok += 1
                print(f"  ok: trace {rec['lower_s']}s args/device "
                      f"{rec['memory']['argument_size_in_bytes'] / 1e9:.2f}GB "
                      f"flops {rec['cost']['flops']:.3g} "
                      f"coll {rec['collectives']['total'] / 1e9:.2f}GB",
                      flush=True)
            except Exception as e:  # noqa: BLE001 - record and continue
                rec = {"arch": arch, "shape": shape, "mesh": mesh_tag,
                       "error": f"{type(e).__name__}: {e}"[:2000],
                       "where": _where(e),
                       "trace": traceback.format_exc()[-2000:]}
                n_fail += 1
                print(f"  FAIL: {rec['error'][:300]}", flush=True)
            f.write(json.dumps(rec) + "\n")
            f.flush()
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
