"""Device time of the bf16 ``paged_decode`` kernel against its split count.

    PYTHONPATH=src python -m repro_torch.launch.decode_splits

For each shape in ``SHAPES`` (Llama-3.1-8B's heads at the B=8 main shape of
``chip_smoke.py``, the engine's own B=4 decode step, one sequence, 16 and
32 sequences; chatglm3-6b's heads) and each split count in ``SPLITS``, it
prints the kernel's device time (torch.profiler, merge included) warm, one
input set called 20 times (a K/V set under 50 MB then stays in L2), and
cold, 8 input sets over disjoint pages of one pool, cycled, so no call
finds its K/V in L2, as a decode step's call, one of 32 layers, does not.
Each line names the count ``choose_splits`` picks. The output is checked
against the plain version at every count. It needs a card.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import sys

#: name: B, Hq, Hkv, table width in pages, lengths [low, high); D 128, page 16
SHAPES = {"main": (8, 32, 8, 256, (1024, 4097)),
          "engine": (4, 32, 8, 128, (1032, 1101)),
          "b1": (1, 32, 8, 128, (1032, 1101)),
          "b16": (16, 32, 8, 128, (1032, 1101)),
          "b32": (32, 32, 8, 256, (2048, 4097)),
          "chatglm": (4, 32, 2, 256, (1024, 4097))}
SPLITS = (1, 2, 3, 4, 5, 6, 8, 12, 16)
SETS = 8


def main() -> int:
    import numpy as np
    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.paged_decode import (choose_splits,
                                                  paged_decode_attention)
    from repro_torch.kernels.ref import MAIN_SHAPE_BF16_TOL, ref_paged_decode
    from repro_torch.launch.timing import device_ms

    if not torch.cuda.is_available():
        print("decode_splits: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sms = _build.sm_count(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    g = torch.Generator(device=dev).manual_seed(0)
    D, page = 128, 16
    for name, (B, Hq, Hkv, npages, (lo, hi)) in SHAPES.items():
        rng = np.random.default_rng(0)
        ln = rng.integers(lo, hi, B)
        live = -(-ln // page)
        P = SETS * int(live.sum()) + 1
        kp, vp = (torch.randn((P, page, Hkv, D), generator=g,
                              device=dev).bfloat16() for _ in range(2))
        perm = rng.permutation(np.arange(1, P))
        sets = []
        for _ in range(SETS):
            bt = np.zeros((B, npages), np.int64)
            for b, n in enumerate(live):
                bt[b, :n], perm = perm[:n], perm[n:]
            sets.append((torch.randn((B, Hq, D), generator=g,
                                     device=dev).bfloat16(),
                         torch.tensor(bt, dtype=torch.int32, device=dev)))
        lengths = torch.tensor(ln, dtype=torch.int32, device=dev)
        q, bt = sets[0]
        want = ref_paged_decode(q, kp, vp, bt, lengths).float()
        for n in SPLITS:
            got = paged_decode_attention(q, kp, vp, bt, lengths, splits=n)
            torch.testing.assert_close(got.float(), want,
                                       **MAIN_SHAPE_BF16_TOL)
            warm = device_ms(lambda: paged_decode_attention(
                q, kp, vp, bt, lengths, splits=n))
            cycle = itertools.cycle(sets)

            def cold():
                qq, bb = next(cycle)
                return paged_decode_attention(qq, kp, vp, bb, lengths,
                                              splits=n)
            print(json.dumps({
                "shape": name, "B": B, "Hq": Hq, "Hkv": Hkv,
                "key_capacity": npages * page, "lengths": ln.tolist(),
                "kv_bytes": int(ln.sum()) * Hkv * D * 2 * 2, "splits": n,
                "chosen": n == choose_splits(B, Hkv, npages * page, sms),
                "warm_ms": warm, "cold_ms": device_ms(cold, iters=24),
                "card": card}), flush=True)
        del kp, vp, sets
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
