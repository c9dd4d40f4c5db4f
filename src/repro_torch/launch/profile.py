"""Where the main path's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile [--chunked] [n_layers]

Builds the engine ``chip_smoke.py`` phase 4 serves (``launch/main_path.py``:
Llama-3.1-8B, bf16, seeded random weights, a base + 2 full-weight decode
models, 2048 pages of 16 tokens; with ``--chunked`` the phase 5 engine,
``main_path.CHUNKED``), opens a shared 1000-token context and runs one
untraced warm-up turn (the context's prefill is timed warm by
``chip_smoke.py``; here it also pays the kernels' first-use builds).
Then it measures, untraced:
  - prefill of 4 32-token tails over the cached context: eager, the wall
    time of the 4 ``generate`` calls (per request); chunked, where
    ``generate`` only queues, the wall time of the first step after them
    (one B=4 chunk forward, the handoffs and the first decode step);
  - fused decode: 8 steps of the resulting batch of 4, each bracketed by
    CUDA events;
then the device time (``launch.timing.device_ms``) of one fused decode
step of that batch, and finally traces, with ``torch.profiler``, one more
request's prefill and 8 steps, and prints the device time by kernel (top
25), the device time per kernel class (matrix products, paged_decode,
paged_write, flash_prefill_paged, the rest) and the device's busy share of
the traced window's wall time. Last, the device time of a new
1000-token context's prefill (chunked: five 200-token chunk forwards;
eager: one prefill), a fresh prompt each time, so no prefix is reused.
``chip_smoke.py`` phase 18 sets these beside the serving simulator's cost
model. It needs a card.
"""
from __future__ import annotations

import json
import sys
import time


def _kernel_class(name: str) -> str:
    """A kernel's class by its name. The split's merge kernel
    (``csrc/merge_splits.cuh``) is a template on a tag that names its
    caller, ``paged_decode_merge`` or ``flash_prefill_paged_merge``, and is
    counted with that caller."""
    n = name.lower()
    if "paged_decode" in n:
        return "paged_decode"
    if "paged_write" in n:
        return "paged_write"
    if "flash_prefill_paged" in n:
        return "flash_prefill_paged"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "cublas", "sm90_xmma",
                            "nvjet")):
        return "matmul"
    if "memcpy" in n or "memset" in n:
        return "memcpy"
    return "other"


def main(argv) -> int:
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.main_path import (CHUNKED, PROMPT_TOKENS,
                                              TAIL_TOKENS, build_engine,
                                              tokens)
    from repro_torch.launch.timing import device_ms
    from repro_torch.serving import SamplingParams

    if not torch.cuda.is_available():
        print("profile: needs a CUDA card", file=sys.stderr)
        return 1
    chunked = "--chunked" in argv
    argv = [a for a in argv if a != "--chunked"]
    cfg, eng = build_engine(int(argv[0]) if argv else None,
                            **(CHUNKED if chunked else {}))
    rng = np.random.default_rng(0)
    prompt = tokens(cfg, rng, PROMPT_TOKENS)

    def tail():
        return tokens(cfg, rng, TAIL_TOKENS)

    models = ("m0", "m0", "m1", "m1")
    ctx = eng.shared_context(prompt)
    for m in models:                                  # warm-up turn
        ctx.generate(m, tail(), SamplingParams(max_tokens=4))
    eng.run()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in models:
        ctx.generate(m, tail(), SamplingParams(max_tokens=32))
    if chunked:
        eng.step()               # the B=4 chunk forward, handoffs, 1 decode
    torch.cuda.synchronize()
    prefill_s = (time.perf_counter() - t0) / (1 if chunked else len(models))
    step_ms = []
    for _ in range(8):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        eng.step()
        e1.record()
        e1.synchronize()
        step_ms.append(e0.elapsed_time(e1))
    step_device_ms = device_ms(eng.step, iters=8)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        ctx.generate("m0", tail(), SamplingParams(max_tokens=32))
        for _ in range(8):
            eng.step()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - w0
    eng.run()
    ctx.close()

    def context_prefill():
        eng.shared_context(tokens(cfg, rng, PROMPT_TOKENS)).close()
    context_device_ms = device_ms(context_prefill, iters=3)

    by_class: dict = {}
    busy_us = 0.0
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()
        busy_us += us
        c = _kernel_class(ev.name)
        by_class[c] = by_class.get(c, 0.0) + us
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=25))
    card = torch.cuda.get_device_name(0)
    print(json.dumps({
        "card": card, "n_layers": cfg.n_layers, "chunked": chunked,
        ("first_step_s" if chunked else "prefill_s_per_request"): prefill_s,
        "decode_step_ms": step_ms,
        "decode_step_device_ms": step_device_ms,
        "context_tokens": PROMPT_TOKENS,
        "context_prefill_device_ms": context_device_ms,
        "traced_window_s": window_s,
        "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / window_s,
        "device_ms_by_class": {k: v / 1e3 for k, v in sorted(by_class.items())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
