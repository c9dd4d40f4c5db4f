#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [n_layers]     # default: all 32 layers

Phases, in order; any failure exits non-zero (nothing is caught):
  1. device and build: the card's name and power limit; the four CUDA
     sources built with nvcc for sm_90a, one process each, with ptxas'
     register/shared-memory/spill report (a tensor-core kernel that spills
     fails the run);
  2. each Hopper kernel against its plain PyTorch version: the reference's
     kernel-test cases (plus head_dim 16, the toy configs', and a query
     group of 16 at head_dim 256), chatglm3-6b's heads (group 16) at decode
     and chunk shapes for both paged kernels in fp32 (2e-5) and bf16,
     granite-moe-3b-a800m's (group 3 at head_dim 64) at the engine's decode
     step, the chunk shapes and the folded write for all three paged
     kernels in fp32 and bf16, timed (heads read from the configs), and
     the main path's shapes (bf16 held to ``kernels.ref.MAIN_SHAPE_BF16_TOL``
     and ``MAIN_SHAPE_PREFILL_BF16_TOL``; ``paged_decode`` at B=8 and at the
     engine's own B=4 decode step, ``DECODE_SHAPES``, with the split count
     chosen), with CUDA-event times of the kernel alone, the plain version
     and a library yardstick, and the bound. Dense ``flash_prefill``: the
     reference's cases and the edges its tests leave out (rows with no
     visible key exactly 0, S != T, windows of 1 and past T, group 16,
     head_dim 256), then, through
     ``repro_torch.kernels.flash_attention``, Llama-3.1-8B's heads at
     S = T = 1000 and 8192 (causal) and Gemma-2-27B's at 8192 (window 4096,
     softcap 50) in bf16 (``MAIN_SHAPE_FLASH_BF16_TOL``), and the 1000-token
     shape in fp32 (2e-5);
  3. toy fp32 engines on the card against the same engines on the CPU, at
     head_dim 16 (the reference's toy config) and 32: identical greedy
     tokens, eager and chunked (chunk sizes 3 and 8, boundaries mid-page),
     and chunked equal to eager; sentinel pool row 0 still zero after a
     ragged fused batch; tests/test_preempt.py's contention fleet (18
     pages of 8) with ``preempt=True, overcommit=2.0, sanitize=True`` in
     forced swap and forced recompute mode: card tokens == CPU tokens ==
     the unarmed run's, same preemption counters; an ``autoscale=`` engine
     whose prefill pool grows gives a fixed pool's tokens;
  4. the main path at full width (``repro_torch.launch.main_path``):
     LocalDisaggEngine serving Llama-3.1-8B (32 layers, bf16, seeded random
     weights) with a base model and two full-weight decode models over a
     2048-page pool: a shared ~1000-token context, two requests per model,
     then a second turn that hits the prefix cache; launch counters are
     zeroed just before and read just after, and peak device memory must
     stay within the weights, held once, plus the pool and 2 GiB; TTFT and
     ITL p50/p95 from ``engine.metrics()``, and ``render_prometheus()``
     held to ``lint_prometheus``. Then the kernel API's path over the same
     base weights: layer 0's post-RoPE q/k/v of the shared context through
     ``kernels.flash_attention`` (counters zeroed just before, read just
     after), held against the port's dense ``models.attention.attention``
     on the same q/k/v. Then phase 8;
  5. the chunked main path: the same weights served by a new engine
     (``chunked=True``, 200-token chunks, a 512-token budget) over a fresh
     pool, phase 4's pool freed first; the same traffic. Every prefill goes
     through ``flash_prefill_paged`` (and ``paged_write`` never launches);
     the same memory bound; the chunk forwards are phase 2's shapes. The
     shared context's K/V against phase 4's, relative norm per layer, is
     held under a ceiling of (layer + 1) * 2**-8; how many greedy tokens
     agree with phase 4 is printed, not asserted; metrics as in phase 4.
     Then phase 11, then phase 9;
  6. the same two paths at full width in fp32, depth cut to 4 layers, same
     traffic: greedy tokens identical and context K/V within
     ``FP32_KV_REL`` per layer; then phase 11's preemption fleet at this
     depth in fp32, greedy and seeded: forced swap and forced recompute
     give the tokens of the unarmed run (asserted). Then phase 10;
  7. device times: at the chunk shapes the kernels finish faster than the
     Python wrapper launches them, so back-to-back CUDA-event times measure
     the host. torch.profiler's records give the device time of the three
     attention kernels redesigned for the tensor cores (and of SDPA beside
     the paged ones) at the main shapes, ``paged_decode`` at both
     ``DECODE_SHAPES``; then the sampler on logits of phase 8's step and
     one decode step's LoRA merge over phase 9's base and adapters (kept
     until here), in all and by kernel. Last, because the profiler leaves
     CUPTI active in the process and slows every later launch, which would
     move the host-bound times of phases 3-6 and 8-10;
  8. (after phase 4) sampled requests (``SAMPLED``: temperature 0.8,
     top_k 50, top_p 0.9, explicit seeds) over phase 4's weights and shared
     context, each served alone, then packed with a greedy request and a
     sampled request of each model (phase 4's turn-0 batch shape): sampled
     tokens identical across the packings, the packed greedy rows equal to
     phase 4's tokens, a ``seed=None`` request seeded with its request id;
     the time the sampler adds to that step by CUDA events (its device time
     in phase 7). Each serve gets a fresh pool (an empty prefix cache), so
     every prefill has phase 4's shapes;
  9. (after phase 5) four LoRA decode models (rank 16, alpha 32,
     wq/wv/wo, seeded nonzero B) over phase 4's base at full width and
     depth, the full decoders and phase 5's pool freed: one fused dispatch
     per step, greedy and sampled; peak memory within the base held once,
     the adapters, the pool, one layer's merged weights for the four lanes
     and 2 GiB; the plane's ``param_bytes`` beside four full decoders'; a
     step's wall time (the merge's device time in phase 7). Then phase
     18;
  10. (after phase 6) four LoRA decode models at full width, depth cut to
     4 layers, fp32 and bf16: tokens of the fused LoRA group == the
     all-full plane of the materialized trees, and in fp32 also == the
     per-model path (lazily materialized ``lora_apply``); in bf16 the
     per-model path's agreement is printed, not asserted;
  11. (after phase 5) priority preemption at full width and depth: a
     chunked engine over phase 4's two stacked decoders (row 1 is the base
     and the relay-compatible model "mb", row 0 the swap-only "m0";
     ``main_path.preempt_engine``), six low-priority 200-token prompts
     decoding 128 tokens, then two priority-5 1000-token prompts decoding
     32; unarmed over 512 pages, then ``preempt=True, overcommit=2.0,
     sanitize=True`` over ``PREEMPT_PAGES`` (which the low-priority decodes
     fill) in forced swap, forced recompute and auto mode. Each armed run
     preempts, its sanitizer passes at every step, its free pages return to
     baseline, its peak memory stays within the weights + pool + 2 GiB,
     and every swap restore reads back bit for bit what ``put`` read (into
     other rows). Prints the host link each way, the seconds per swap, the
     cost model's re-prefill prediction beside the measured chunk time,
     auto mode's choices, high-priority TTFT/ITL p50/p95 armed and
     unarmed, and the greedy tokens that agree with the unarmed run (not
     asserted in bf16). Then relay over the same pair, eager over
     ``ROOMY_PAGES``: a 1000-token prompt answered by "mb", then a prompt
     that extends it by the answer; with ``relay=True`` the answer's
     decode-written pages are published and the follow-up's prefill hits
     them (asserted), with ``relay=False`` nothing is published;
  12. (after phase 10) MoE on the paged main path: granite-moe-3b-a800m
     at full width and depth (bf16, seeded random weights with output
     projections scaled by ``main_path.OUT_SCALE``), phase 4's traffic
     eager, then phase 5's chunked over the same weights on a fresh pool:
     launches of ``paged_write`` (eager), ``flash_prefill_paged``
     (chunked) and ``paged_decode`` (both), counted just before and read
     just after each path, the memory bound, free pages back to baseline,
     TTFT/ITL p50/p95, the prefills' ``dropped_frac`` by forward shape and
     the chunked-against-eager token agreement (printed: expert capacity
     depends on each forward's S); then 4 layers in fp32 (output
     projections at ``FP32_OUT_SCALE``): the base's logits and the greedy
     tokens, eager and chunked, card == CPU, with at least
     ``FP32_MIN_DISTINCT`` distinct tokens;
  13. the dense fallback at full width, one arch at a time (weights freed
     before the next): mamba2-780m, recurrentgemma-2b,
     seamless-m4t-medium and gemma2-27b (4 layers), a base and two
     decoders, one session (a 1000-token context, two turns of one
     32-token request per model, a seeded sampled request and a one-shot
     one): prefix reuse, the session's pages released by ``end_session``,
     peak memory while serving within the weights + 2 GiB, TTFT, the B=1
     decode loop's wall a token; then 2-3 layers in fp32 (as in 12): the
     base's logits and the greedy tokens, card == CPU, with at least
     ``FP32_MIN_DISTINCT`` distinct tokens.
  14. training (after phase 13; plain torch, no kernel: no TPU kernel lies
     on the training path): ``launch/train.py``'s path on internlm2-1.8b
     at full width and depth (24 layers, d_model 2048, vocab 92544, bf16,
     seeded random weights), ``TRAIN_STEPS`` pretraining steps, the base's
     checkpoint, ``TRAIN_STEPS`` cache-conditioned (Eq. 7) steps of a
     full-weight decoder initialised as the base, its checkpoint and
     ``evaluate`` at share ratio 1: each step's wall, tokens/s, peak
     memory and the losses; the losses finite, the base bit-unchanged by
     fine-tuning, the decoder changed, both checkpoints read back
     bit-equal;
  15. one ``train_loss`` step of that base at S=4096, B=1, ``remat=True``
     (past the reference's flash switch: ``_FlashAttention`` forward twice
     and backward once a layer, counted): loss + backward and the AdamW
     update timed, peak memory;
  16. Llama-3.1-8B at full width and depth (phase 9's base) fine-tuned
     through ``cache_conditioned_lora_loss`` (rank 16, wq/wv/wo) over phase
     4's shared 1000-token context, 4 rows of 32-token targets: each
     step's wall and peak memory; the base bit-unchanged, the adapters
     changed;
  17. internlm2-1.8b at full width in fp32, 2 layers: the Eq. 7 loss
     (share ratio 0.5), every gradient leaf and one AdamW update, card
     against CPU, then ``_FlashAttention``'s o/dq/dk/dv at the model's
     heads over 1024 tokens, card against CPU (tolerances in
     ``phase_train_fp32``). Phases 14-17 run before phase 7, whose
     profiler would slow them.
  18. (after phase 9) the serving simulator and its launcher: ``python -m
     repro_torch.launch.serve --engine local`` on the card and with
     ``--device cpu``, each in a process of its own (identical output,
     asserted); the simulator (``serving/simulator.py``) at Llama-3.1-8B
     width on the H100's figures, react, baseline and PrefillShare at
     ``SIM_RATES`` (every session completes; p95 e2e, p95 TTFT, throughput
     and their ratios printed beside the paper's 4.5x/3.9x); what its
     ``CostModel`` charges for phase 5's 200-token chunk forwards and phase
     4's fused decode step, beside their wall times and the device times
     that ``python -m repro_torch.launch.profile --chunked`` (a process of
     its own) measures; and decode-plane relayouts on phase 9's plane (a
     fifth LoRA adapter registered, then unregistered), the simulator's
     ``churn_rebuild_s``.
  19. (after phase 15, on phase 14's internlm2-1.8b weights) the step
     builders at full width (``launch/steps.py``, ``STEP_SHAPES``: decode
     B=4 against a 32768-token cache, prefill B=1 S=32768, a train step of
     4 x 4096 tokens with bf16 moments): the materialized arguments hold
     exactly the single-device dry run's ``argument_size_in_bytes`` and
     ``memory_allocated`` grows by them within ``MEM_REL``; each step
     twice by CUDA events, finite outputs, the serve step's greedy tokens
     equal to ``forward``'s; the dry run's flops over the device time
     beside 989 TFLOP/s, its temp beside ``max_memory_allocated``. The dry
     runs (fake tensors, host only) run in a process started before phase
     1. After phase 4: one row's bf16 logits through the fused decode step
     at batch widths 1, 2, 4 and 8 (printed, not asserted).
  20. (after phase 4, on its engine) the reference's request-id surface:
     one request per decode model over phase 4's shared context plus a
     32-token tail through ``submit`` on a caller-managed session, then
     ``run``; then ``generate`` of the same prompt on the same session
     (the same pages: no recompute) and ``run``. ``result(rid)`` equals
     ``generate(...).result()``, ``pop_result`` releases the entry and a
     second ``pop_result`` raises; both warn as deprecated; the launch
     counters of ``paged_write``, ``paged_decode`` and
     ``flash_prefill_paged`` zeroed just before and read just after. In
     phase 13, on mamba2-780m's engine: ``invoke`` equals
     ``generate(...).result()`` over a fresh 1000-token context.
The last two lines are the card's nvidia-smi name/power line and
``{"ok": true, "device": {...}}``. It needs the repository's ``src/``
beside it and a CUDA card; without either it prints no result and exits 1.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
FP32_FLOPS = 67e12                 # H100 SXM fp32 outside the tensor cores
PEAK_SLACK_BYTES = 2 << 30         # main path's activations above its weights


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / iters


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def diff_ms(a, b):
    """``a - b``, or None (not measured) when either is."""
    return None if a is None or b is None else a - b


# ======================================================================
# phase 1


def phase_build():
    from repro_torch.kernels import _build
    t = time.perf_counter()
    reports = _build.build_all(force=True)
    log(f"[build] {sorted(reports)} in {time.perf_counter() - t:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    spills = []
    for name, out in sorted(reports.items()):
        entry = None
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[ptxas {name}] {line.strip()}")
            if "Compiling entry" in line:
                entry = line
            elif "tc_kernel" in (entry or "") and re.search(
                    r"[1-9]\d* bytes spill (stores|loads)", line):
                spills.append(entry)
    # the tensor-core kernels keep their fragments in registers
    assert not spills, f"tensor-core kernels spill: {spills}"


# ======================================================================
# phase 2


PAGED_CASES = [
    # B, Hq, Hkv, D, page, npages, pool  (tests/test_kernels.py)
    (3, 8, 2, 64, 16, 8, 40),
    (1, 4, 4, 128, 32, 4, 16),
    (2, 8, 1, 64, 16, 16, 64),
    (4, 2, 2, 32, 8, 4, 20),
    (4, 2, 1, 16, 8, 4, 20),           # head_dim 16 (the toy configs)
    (2, 16, 1, 256, 16, 4, 12),        # group 16 at head_dim 256
]


def config_heads(name: str, page: int = 16) -> dict:
    """A config's attention heads (``repro_torch.configs``) with a page
    size: chatglm3-6b's (32 query heads over 2 kv heads, a query group of
    16, head_dim 128) are paged-eligible in the reference and taken by both
    paged kernels; granite-moe-3b-a800m's (24 over 8, a group of 3, head_dim
    64) are phase 12's main path."""
    from repro_torch.configs.base import get_config
    c = get_config(name)
    return dict(Hq=c.n_heads, Hkv=c.n_kv_heads, D=c.head_dim, page=page)


PREFILL_CASES = [
    # B, Hq, Hkv, D, page, npages, pool, S  (tests/test_kernels.py)
    (2, 4, 2, 64, 8, 4, 16, 5),        # chunk boundary mid-page
    (1, 8, 1, 32, 16, 3, 8, 16),       # MQA, chunk == page
    (3, 2, 2, 64, 8, 6, 32, 7),        # MHA, ragged starts
    (1, 4, 2, 128, 16, 2, 8, 1),       # degenerate single-token chunk
    (2, 4, 2, 64, 8, 4, 12, 6),        # the reference's softcap case
    (3, 2, 1, 16, 8, 6, 24, 11),       # head_dim 16 (the toy configs)
    (2, 16, 2, 128, 16, 16, 64, 37),   # group 8, many row and key tiles
    (2, 16, 1, 256, 16, 8, 24, 37),    # group 16 at head_dim 256
]
# the chunked main path's chunk forwards (phase 5), B, S, start: the shared
# 1000-token context in 200-token chunks (starts mid-page), then each turn's
# four tails batched into one forward past the 992 cached tokens: 40
# uncached tokens each in turn 1, 72 in turn 2 (its context grew by turn 1's
# 32-token answer)
MAIN_CHUNKS = [(1, 200, st) for st in (0, 200, 400, 600, 800)] + [
    (4, 40, 992), (4, 72, 992)]


#: the bf16 decode shapes phase 2 times and phase 7 profiles, Llama-3.1-8B's
#: heads (Hq 32, Hkv 8, D 128, page 16, a 2049-page pool): B, table width,
#: lengths (low, high), engine layout. "main": B=8 at 1k-4k tokens over
#: random tables 256 pages wide; "engine": the engine's own fused decode
#: step (2 models x 2 rows, serving/decode.py) over the main path's
#: ~1000-token context, tables bucketed to 128 pages with distinct pages and
#: sentinel page 0 past each sequence
DECODE_SHAPES = {"main": (8, 256, (1024, 4097), False),
                 "engine": (4, 128, (1032, 1101), True)}


def decode_shape_inputs(name, g, heads=(32, 8, 128, 16), dtype=None):
    """q, k/v pools, block tables and lengths of DECODE_SHAPES[name] on the
    card, bf16 unless ``dtype``, Llama-3.1-8B's heads unless ``heads`` (Hq,
    Hkv, D, page); random values from the CUDA generator ``g``, lengths
    (and the engine layout's pages) from numpy seed 0."""
    import numpy as np
    import torch
    B, npages, (lo, hi), engine = DECODE_SHAPES[name]
    (Hq, Hkv, D, page), P = heads, 2049
    dtype = dtype or torch.bfloat16
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ln = rng.integers(lo, hi, B)
    q = torch.randn((B, Hq, D), generator=g, device=dev).to(dtype)
    kp = torch.randn((P, page, Hkv, D), generator=g, device=dev).to(dtype)
    vp = torch.randn((P, page, Hkv, D), generator=g, device=dev).to(dtype)
    if engine:
        bt = np.zeros((B, npages), np.int64)
        perm = rng.permutation(np.arange(1, P))
        for b, n in enumerate(-(-ln // page)):
            bt[b, :n] = perm[:n]
            perm = perm[n:]
        bt = torch.tensor(bt, dtype=torch.int32, device=dev)
    else:
        bt = torch.randint(0, P, (B, npages), generator=g, device=dev,
                           dtype=torch.int32)
    return q, kp, vp, bt, torch.tensor(ln, dtype=torch.int32, device=dev)


def decode_sdpa_inputs(q, kp, vp, bt, ln):
    """The yardstick's inputs: K/V gathered into dense (B, Hkv, T, D)
    beforehand (the gather is not timed), the length mask, and q as
    (B, Hkv, G, D): the G query heads of one kv head are SDPA's query rows,
    which is single-token GQA exactly."""
    import torch
    B, Hq, D = q.shape
    page, Hkv = kp.shape[1], kp.shape[2]
    T = bt.shape[1] * page
    kd, vd = (x[bt.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3)
              .contiguous() for x in (kp, vp))
    mask = (torch.arange(T, device=q.device)[None]
            < ln[:, None])[:, None, None]
    return kd, vd, mask, q.view(B, Hkv, Hq // Hkv, D)


def phase_kernels(card):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode import (choose_splits,
                                                  paged_decode_attention)
    from repro_torch.kernels.paged_write import paged_write
    from repro_torch.kernels.ref import (MAIN_SHAPE_BF16_TOL,
                                         ref_paged_decode, ref_paged_write)
    from repro_torch.launch.main_path import MOE_MODEL

    dev = torch.device("cuda")
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    g = torch.Generator(device=dev).manual_seed(0)

    def decode_inputs(B, Hq, Hkv, D, page, npages, P, dtype, lengths=None):
        q = torch.randn((B, Hq, D), generator=g, device=dev).to(dtype)
        kp = torch.randn((P, page, Hkv, D), generator=g, device=dev).to(dtype)
        vp = torch.randn((P, page, Hkv, D), generator=g, device=dev).to(dtype)
        bt = torch.randint(0, P, (B, npages), generator=g, device=dev,
                           dtype=torch.int32)
        ln = lengths if lengths is not None else torch.randint(
            1, page * npages + 1, (B,), generator=g, device=dev,
            dtype=torch.int32)
        return q, kp, vp, bt, ln

    # --- paged_decode: reference cases, f32/bf16, with and without softcap
    for case in PAGED_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for cap in (0.0, 30.0):
                args = decode_inputs(*case, dtype)
                got = paged_decode_attention(*args, softcap=cap)
                want = ref_paged_decode(*args, softcap=cap)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol[dtype], rtol=tol[dtype])
                log(f"[paged_decode] case {case} {dtype} softcap {cap}: "
                    f"max|err| {err:.3e} (tol {tol[dtype]})")

    # --- paged_decode at chatglm3-6b's heads, 1k-4k tokens
    c = config_heads("chatglm3-6b")
    lengths = torch.tensor(np.random.default_rng(1).integers(1024, 4097, 4),
                           dtype=torch.int32, device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for cap in (0.0, 30.0):
            args = decode_inputs(4, c["Hq"], c["Hkv"], c["D"], c["page"], 256,
                                 1025, dtype, lengths)
            got = paged_decode_attention(*args, softcap=cap)
            want = ref_paged_decode(*args, softcap=cap)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            t = (MAIN_SHAPE_BF16_TOL if dtype == torch.bfloat16
                 else {"atol": 2e-5, "rtol": 2e-5})
            torch.testing.assert_close(got.float(), want.float(), **t)
            log(f"[paged_decode] chatglm3-6b heads B=4 Hq={c['Hq']} "
                f"Hkv={c['Hkv']} (group 16) D={c['D']} page {c['page']} "
                f"{dtype} softcap {cap} lengths {lengths.tolist()}: "
                f"max|err| {err:.3e} (tol {t})")

    # --- paged_decode at the main path's shapes: chip_smoke's B=8 and the
    # engine's own B=4 step (DECODE_SHAPES), Llama-3.1-8B's heads in bf16;
    # then the engine step at granite-moe-3b-a800m's heads (phase 12) in
    # bf16 and fp32
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gr = config_heads(MOE_MODEL)
    granite = (gr["Hq"], gr["Hkv"], gr["D"], gr["page"])
    bf16, fp32 = torch.bfloat16, torch.float32
    dec = {}
    for label, name, heads, dtype in (
            ("main", "main", (32, 8, 128, 16), bf16),
            ("engine", "engine", (32, 8, 128, 16), bf16),
            ("granite-moe engine", "engine", granite, bf16),
            ("granite-moe engine", "engine", granite, fp32)):
        q, kp, vp, bt, ln = decode_shape_inputs(name, g, heads, dtype)
        B, Hq, D = q.shape
        page, Hkv = kp.shape[1], kp.shape[2]
        npages = bt.shape[1]
        splits = choose_splits(B, Hkv, npages * page, sms)
        tol_d = (MAIN_SHAPE_BF16_TOL if dtype == bf16
                 else {"atol": 2e-5, "rtol": 2e-5})
        got = paged_decode_attention(q, kp, vp, bt, ln)
        want = ref_paged_decode(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        torch.testing.assert_close(got.float(), want.float(), **tol_d)
        capped = paged_decode_attention(q, kp, vp, bt, ln, softcap=30.0)
        want_c = ref_paged_decode(q, kp, vp, bt, ln, softcap=30.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(capped.float(), want_c.float(), **tol_d)
        err_c = (capped.float() - want_c.float()).abs().max().item()
        del capped, want_c
        ms = cuda_ms(lambda: paged_decode_attention(q, kp, vp, bt, ln))
        plain = cuda_ms(lambda: ref_paged_decode(q, kp, vp, bt, ln))
        kd, vd, mask, qg = decode_sdpa_inputs(q, kp, vp, bt, ln)
        lib_out = F.scaled_dot_product_attention(qg, kd, vd, attn_mask=mask)
        torch.testing.assert_close(lib_out.reshape(B, Hq, D).float(),
                                   want.float(), atol=2e-2, rtol=2e-2)
        lib = cuda_ms(lambda: F.scaled_dot_product_attention(
            qg, kd, vd, attn_mask=mask))
        L = int(ln.sum())
        live_pages = int(((ln + page - 1) // page).sum())
        isz = q.element_size()
        nbytes = (L * Hkv * D * 2 * isz + 2 * q.numel() * isz
                  + live_pages * 4 + B * 4)
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 4 * Hq * D * L / (BF16_FLOPS if dtype == bf16
                                  else FP32_FLOPS)
        bound = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        log(f"[paged_decode] {label} shape B={B} Hq={Hq} Hkv={Hkv} "
            f"(group {Hq // Hkv}) D={D} page={page} npages={npages} "
            f"{str(dtype).removeprefix('torch.')} lengths {ln.tolist()}, "
            f"{splits} key part(s) on {sms} SMs: max|err| {err:.3e}, "
            f"relative norm {rel:.3e}, softcap 30 max|err| {err_c:.3e} "
            f"(tol {tol_d}); kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa on pre-gathered dense "
            f"K/V (gather excluded) {lib:.4f} ms, bound {bound:.4f} ms by "
            f"{by} ({nbytes} B) on {card}")
        dec[(label, dtype)] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                                   bound_ms=bound, bound_by=by,
                                   library_ms=lib)
        del q, kp, vp, kd, vd

    # --- paged_write: reference cases, then Llama's 32 folded layers
    for case in [(3, 64, 2, 32, 16, 24), (1, 32, 4, 64, 8, 12),
                 (2, 128, 1, 128, 32, 16)]:
        for dtype in (torch.float32, torch.bfloat16):
            b, s, h, d, pg, p = case
            nk = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
            nv = torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)
            kpool = torch.randn((p, pg, h, d), generator=g, device=dev).to(dtype)
            vpool = torch.randn((p, pg, h, d), generator=g, device=dev).to(dtype)
            rng = np.random.default_rng(1)
            tbl = rng.permutation(p)[:b * (s // pg)].reshape(b, -1)
            nvl = rng.integers(1, s // pg + 1, b)
            wk, wv = ref_paged_write(nk, nv, kpool.clone(), vpool.clone(),
                                     tbl, nvl)
            paged_write(nk, nv, kpool, vpool, tbl, nvl)
            torch.cuda.synchronize()
            assert torch.equal(kpool, wk) and torch.equal(vpool, wv), case
            log(f"[paged_write] case {case} {dtype}: bitwise equal")

    # Llama-3.1-8B's 32 folded layers (bf16), then granite-moe-3b-a800m's
    # (Hkv 8, D 64; phase 12's eager prefill) in bf16 and fp32
    wr = {}
    for label, (Hkv, D), dtype in (
            ("Llama", (8, 128), bf16),
            ("granite-moe", (gr["Hkv"], gr["D"]), bf16),
            ("granite-moe", (gr["Hkv"], gr["D"]), fp32)):
        wr[(label, dtype)] = write_fold(card, g, label, Hkv, D, dtype)
    torch.cuda.empty_cache()
    return {
        "flash_prefill": phase_flash_kernel(card),
        "flash_prefill_paged": phase_prefill_kernel(card),
        "paged_decode": dec[("main", bf16)],
        "paged_write": wr[("Llama", bf16)],
    }


def write_fold(card, g, label, Hkv, D, dtype):
    """paged_write of 32 folded layers' 1024-token prompt (the eager
    prefill's one launch per group), ``Hkv`` x ``D`` heads, page 16, a
    2049-page pool: bitwise equal to the plain version, pages past n_valid
    untouched; timed with tables on the card, through the wrapper, plain,
    and ``index_copy_``. Returns the JSON record."""
    import numpy as np
    import torch

    from repro_torch.kernels.paged_write import (launch_on_device_tables,
                                                 paged_write)
    from repro_torch.kernels.ref import ref_paged_write

    dev = torch.device("cuda")
    n_full, prompt, npg = 32, 1024, 64
    page, P1 = 16, 2049
    nk = torch.randn((n_full, prompt, Hkv, D), generator=g,
                     device=dev).to(dtype)
    nv = torch.randn((n_full, prompt, Hkv, D), generator=g,
                     device=dev).to(dtype)
    kpool = torch.randn((n_full * P1, page, Hkv, D), generator=g,
                        device=dev).to(dtype)
    vpool = torch.randn_like(kpool)
    pages = np.random.default_rng(2).permutation(np.arange(1, P1))[:npg]
    tbl = (pages[None] + (np.arange(n_full) * P1)[:, None]).astype(np.int32)
    nvl = np.full((n_full,), npg - 4, np.int32)      # last 4 pages not valid
    k0, v0 = kpool.clone(), vpool.clone()
    wk, wv = ref_paged_write(nk, nv, kpool.clone(), vpool.clone(), tbl, nvl)
    paged_write(nk, nv, kpool, vpool, tbl, nvl)
    torch.cuda.synchronize()
    assert torch.equal(kpool, wk) and torch.equal(vpool, wv)
    skipped = torch.from_numpy(tbl[:, npg - 4:].reshape(-1)).long().to(dev)
    assert torch.equal(kpool[skipped], k0[skipped])
    assert torch.equal(vpool[skipped], v0[skipped])
    wr_err = max((kpool.float() - wk.float()).abs().max().item(),
                 (vpool.float() - wv.float()).abs().max().item())
    del wk, wv, k0, v0
    # kernel alone: tables uploaded once; the wrapper adds a host check of
    # the targets and two uploads per call
    tbl_d = torch.from_numpy(tbl).to(dev)
    nvl_d = torch.from_numpy(nvl).to(dev)
    wr_ms = cuda_ms(lambda: launch_on_device_tables(nk, nv, kpool, vpool,
                                                    tbl_d, nvl_d))
    wr_wrapper = cuda_ms(lambda: paged_write(nk, nv, kpool, vpool, tbl, nvl))
    wr_plain = cuda_ms(lambda: ref_paged_write(nk, nv, kpool, vpool, tbl,
                                               nvl), iters=3, warmup=1)
    valid = torch.from_numpy(tbl[:, :npg - 4].reshape(-1)).long().to(dev)
    src_k = nk.view(n_full, npg, page, Hkv, D)[:, :npg - 4].reshape(
        -1, page, Hkv, D)
    src_v = nv.view(n_full, npg, page, Hkv, D)[:, :npg - 4].reshape(
        -1, page, Hkv, D)

    def lib_write():
        kpool.index_copy_(0, valid, src_k)
        vpool.index_copy_(0, valid, src_v)
    wr_lib = cuda_ms(lib_write)
    rows = int(valid.numel()) * page * Hkv * D * kpool.element_size()
    wr_bytes = 2 * 2 * rows + tbl.size * 4 + nvl.size * 4
    wr_bound = wr_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[paged_write] {label} fold: {n_full} layers x {prompt}-token "
        f"prompt, Hkv={Hkv} D={D} ({npg - 4}/{npg} pages valid) "
        f"{str(dtype).removeprefix('torch.')}: bitwise equal, pages past "
        f"n_valid untouched; kernel {wr_ms:.4f} ms (tables on the card), "
        f"wrapper with host check and uploads {wr_wrapper:.4f} ms, plain "
        f"{wr_plain:.4f} ms,"
        f" index_copy_ (k and v) {wr_lib:.4f} ms, bound {wr_bound:.4f} ms "
        f"({wr_bytes} B) on {card}")
    del nk, nv, kpool, vpool, src_k, src_v
    return dict(max_abs_err=wr_err, ms=wr_ms, plain_ms=wr_plain,
                bound_ms=wr_bound, bound_by="bytes", library_ms=wr_lib)


def prefill_bound_ms(start, S, Hq, Hkv, D, page, npages, itemsize) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, flops) of one
    flash_prefill_paged call: each visible K/V row, q and the output moved
    once; 4 * Hq * D flops per visible (query, key) pair, at the peak for
    the type (bf16 tensor cores, or fp32 outside them)."""
    T = npages * page
    B = len(start)
    kv_rows = sum(min(st + S, T) for st in start)
    pairs = sum(min(st + i + 1, T) for st in start for i in range(S))
    nbytes = (kv_rows * Hkv * D * 2 * itemsize + 2 * B * S * Hq * D * itemsize
              + B * npages * 4 + B * 4)
    flops = 4 * Hq * D * pairs
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def chunk_table(B, S, st0, page, P, seed):
    """Block tables (B, npages) of B chunks of S tokens at start st0 in the
    engine's layout: as wide as the scheduler buckets them (the next power
    of two of the pages in use), distinct random pages, sentinel page 0 past
    the sequence."""
    import numpy as np

    from repro_torch.serving.decode import next_pow2
    perm = np.random.default_rng(seed).permutation(np.arange(1, P))
    live = -(-(st0 + S) // page)
    bt = np.zeros((B, next_pow2(live)), np.int64)
    for b in range(B):
        bt[b, :live] = perm[b * live:(b + 1) * live]
    return bt


def phase_prefill_kernel(card):
    """flash_prefill_paged against ref_paged_prefill on the card."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_prefill_paged import (choose_splits,
                                                         flash_prefill_paged)
    from repro_torch.kernels.ref import (MAIN_SHAPE_PREFILL_BF16_TOL,
                                         ref_paged_prefill)

    dev = torch.device("cuda")
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    g = torch.Generator(device=dev).manual_seed(3)
    rng = np.random.default_rng(3)

    def inputs(B, Hq, Hkv, D, page, npages, P, S, dtype, start=None,
               bt=None):
        q = torch.randn((B, S, Hq, D), generator=g, device=dev).to(dtype)
        kp = torch.randn((P, page, Hkv, D), generator=g, device=dev).to(dtype)
        vp = torch.randn((P, page, Hkv, D), generator=g, device=dev).to(dtype)
        if bt is None:
            bt = rng.integers(0, P, (B, npages))
        if start is None:               # anywhere, mid-page included
            start = rng.integers(0, npages * page - S + 1, B)
        return (q, kp, vp, torch.tensor(np.asarray(bt), dtype=torch.int32,
                                        device=dev),
                torch.tensor(np.asarray(start), dtype=torch.int32,
                             device=dev))

    for case in PREFILL_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            for cap in (0.0, 30.0):
                args = inputs(*case, dtype)
                got = flash_prefill_paged(*args, softcap=cap)
                want = ref_paged_prefill(*args, softcap=cap)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                torch.testing.assert_close(got.float(), want.float(),
                                           atol=tol[dtype], rtol=tol[dtype])
                log(f"[flash_prefill_paged] case {case} {dtype} softcap "
                    f"{cap} start {args[4].tolist()}: max|err| {err:.3e} "
                    f"(tol {tol[dtype]})")

    # chatglm3-6b's heads (group 16) at the main path's chunk shapes, both
    # types; bf16 held to MAIN_SHAPE_PREFILL_BF16_TOL, fp32 to 2e-5
    c = config_heads("chatglm3-6b")
    for B, S, st0 in ((1, 200, 800), (4, 40, 992)):
        bt = chunk_table(B, S, st0, c["page"], 1025, 6)
        for dtype in (torch.float32, torch.bfloat16):
            for cap in (0.0, 30.0):
                args = inputs(B, c["Hq"], c["Hkv"], c["D"], c["page"],
                              bt.shape[1], 1025, S, dtype, [st0] * B, bt)
                got = flash_prefill_paged(*args, softcap=cap)
                want = ref_paged_prefill(*args, softcap=cap)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                t = (MAIN_SHAPE_PREFILL_BF16_TOL if dtype == torch.bfloat16
                     else {"atol": 2e-5, "rtol": 2e-5})
                torch.testing.assert_close(got.float(), want.float(), **t)
                log(f"[flash_prefill_paged] chatglm3-6b heads B={B} S={S} "
                    f"start {st0} Hq={c['Hq']} Hkv={c['Hkv']} (group 16) "
                    f"D={c['D']} page {c['page']} {dtype} softcap {cap}: "
                    f"max|err| {err:.3e} (tol {t})")

    # the chunked main path's shapes (MAIN_CHUNKS) at Llama-3.1-8B's heads
    # in bf16, then the heaviest context chunk and the turn-1 tail batch at
    # granite-moe-3b-a800m's heads (phase 12) in bf16 and fp32
    from repro_torch.launch.main_path import MOE_MODEL
    gr = config_heads(MOE_MODEL)
    P = 2049
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    perf = None
    bf16, fp32 = torch.bfloat16, torch.float32
    runs = [("main", (32, 8, 128, 16), bf16, c) for c in MAIN_CHUNKS] + [
        ("granite-moe", (gr["Hq"], gr["Hkv"], gr["D"], gr["page"]), dt, c)
        for dt in (bf16, fp32) for c in ((1, 200, 800), (4, 40, 992))]
    for label, (Hq, Hkv, D, page), dtype, (B, S, st0) in runs:
        start = [st0] * B
        bt = chunk_table(B, S, st0, page, P, 4)
        npages = bt.shape[1]
        splits = choose_splits(B, S, Hq, Hkv, npages * page, sms)
        q, kp, vp, btd, std = inputs(B, Hq, Hkv, D, page, npages, P, S,
                                     dtype, start, bt)
        tol_p = (MAIN_SHAPE_PREFILL_BF16_TOL if dtype == bf16
                 else {"atol": 2e-5, "rtol": 2e-5})
        got = flash_prefill_paged(q, kp, vp, btd, std)
        want = ref_paged_prefill(q, kp, vp, btd, std)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        torch.testing.assert_close(got.float(), want.float(), **tol_p)
        ms = cuda_ms(lambda: flash_prefill_paged(q, kp, vp, btd, std))
        plain = cuda_ms(lambda: ref_paged_prefill(q, kp, vp, btd, std))
        # yardstick: K/V gathered into dense (B, Hkv, T, D) beforehand (not
        # timed); a kv head's G query heads x S positions are SDPA's query
        # rows (r = g * S + i), masked by absolute position
        T = npages * page
        G = Hq // Hkv
        kd = kp[btd.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3) \
            .contiguous()
        vd = vp[btd.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3) \
            .contiguous()
        qd = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
            B, Hkv, G * S, D).contiguous()
        qpos = (std[:, None] + torch.arange(S, device=dev)[None]).repeat(
            1, G)                                            # (B, G * S)
        mask = (torch.arange(T, device=dev)[None, None]
                <= qpos[:, :, None])[:, None]                # (B,1,G*S,T)
        lib = F.scaled_dot_product_attention(qd, kd, vd, attn_mask=mask)
        lib_o = lib.reshape(B, Hkv, G, S, D).permute(0, 3, 1, 2, 4).reshape(
            B, S, Hq, D)
        torch.testing.assert_close(lib_o.float(), want.float(),   # sanity
                                   atol=2e-2, rtol=2e-2)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        bound, by, nbytes, flops = prefill_bound_ms(start, S, Hq, Hkv, D,
                                                    page, npages,
                                                    q.element_size())
        log(f"[flash_prefill_paged] {label} shape B={B} S={S} start "
            f"{start[0]} Hq={Hq} Hkv={Hkv} (group {Hq // Hkv}) D={D} "
            f"page={page} npages={npages} "
            f"{str(dtype).removeprefix('torch.')}, {splits} key part(s) on "
            f"{sms} SMs: max|err| {err:.3e}, relative norm {rel:.3e} "
            f"(tol {tol_p}); kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa on pre-gathered dense K/V (gather "
            f"excluded) {lib_ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({nbytes} B, {flops} flop; {flops / ms / 1e9:.2f} TFLOP/s, "
            f"{bound / ms:.3f} of the bound) on {card}")
        if label == "main" and start[0] == 800:   # the heaviest chunk
            perf = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del q, kp, vp, kd, vd, qd, mask, lib
    torch.cuda.empty_cache()
    return perf


FLASH_CASES = [
    # B, Hq, Hkv, S, T, D, causal, window, softcap (tests/test_kernels.py)
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),
    (1, 8, 8, 256, 256, 128, True, 0, 0.0),
    (1, 8, 1, 192, 192, 64, True, 0, 0.0),
    (2, 4, 2, 128, 128, 64, True, 64, 0.0),
    (1, 4, 2, 256, 256, 128, True, 0, 50.0),
    (1, 2, 1, 64, 320, 64, True, 0, 0.0),
    (1, 4, 4, 96, 96, 32, True, 32, 30.0),
    # the edges tests/test_torch_kernels.py adds (FLASH_EDGES)
    (1, 2, 1, 64, 16, 64, True, 8, 0.0),      # rows 23.. see no key
    (2, 4, 2, 48, 80, 32, False, 0, 0.0),
    (1, 4, 2, 80, 48, 32, False, 16, 0.0),     # rows 63.. see no key
    (1, 4, 2, 64, 64, 32, True, 100, 0.0),
    (1, 4, 1, 40, 40, 32, True, 1, 0.0),
    (1, 4, 2, 97, 100, 64, True, 0, 0.0),
    (1, 4, 2, 97, 100, 64, True, 16, 20.0),
    (1, 16, 1, 64, 64, 32, True, 0, 0.0),
    (1, 2, 1, 32, 32, 256, True, 0, 0.0),
    (2, 10, 1, 1000, 1000, 256, True, 0, 0.0),  # MQA group 10, S=1000
]


def flash_main() -> list:
    """name, B, Hq, Hkv, S, T, D, dtype, window, softcap, query scale: the
    full widths the kernel API runs at, read from the configs. Llama-3.1-8B
    (configs/llama31_8b.py) at the main path's 1000-token shared context
    and at 8192; Gemma-2-27B (configs/gemma2_27b.py) at 8192 with its
    4096-token window and softcap 50, its queries scaled by 8 (scores of
    std ~8) so that the cap bends the largest scores
    (tests/test_torch_kernels.py::FLASH_TOL_SHAPES shows that skipping it
    then fails the tolerance); Llama at 1000 in fp32."""
    from repro_torch.configs.base import get_config
    ll, gm = get_config("llama31-8b"), get_config("gemma2-27b")
    lh = (ll.n_heads, ll.n_kv_heads)
    return [
        ("a", 1, *lh, 1000, 1000, ll.head_dim, "bfloat16", 0, 0.0, 1.0),
        ("b", 1, *lh, 8192, 8192, ll.head_dim, "bfloat16", 0, 0.0, 1.0),
        ("c", 1, gm.n_heads, gm.n_kv_heads, 8192, 8192, gm.head_dim,
         "bfloat16", gm.sliding_window, gm.attn_softcap, 8.0),
        ("d", 1, *lh, 1000, 1000, ll.head_dim, "float32", 0, 0.0, 1.0),
    ]


def visible_pairs(S, T, causal, window) -> int:
    """(query, key) pairs under the mask: the work a whole-block-skipping
    kernel must do."""
    import numpy as np
    i = np.arange(S)
    hi = np.minimum(T, i + 1) if causal else np.full(S, T)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, int)
    return int(np.maximum(0, hi - lo).sum())


def flash_bound_ms(B, Hq, Hkv, S, T, D, causal, window, itemsize) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, flops) of one dense
    flash_prefill call: q, k, v and the output moved once; 4 * Hq * D flops
    per visible pair, at the dense peak for the type (bf16 tensor cores, or
    fp32 outside them)."""
    nbytes = (2 * B * Hq * S + 2 * B * Hkv * T) * D * itemsize
    flops = 4 * Hq * D * B * visible_pairs(S, T, causal, window)
    peak = BF16_FLOPS if itemsize == 2 else FP32_FLOPS
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def phase_flash_kernel(card):
    """Dense flash_prefill against ref_flash_prefill on the card: the
    reference's cases and edges, then the full-width shapes through the
    kernel API, timed. Returns the JSON record of shape (a), the main
    path's (the kernel API's path runs the shared 1000-token context)."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.ref import (MAIN_SHAPE_FLASH_BF16_TOL,
                                         ref_flash_prefill)

    dev = torch.device("cuda")
    tol = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
    g = torch.Generator(device=dev).manual_seed(5)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    for B, Hq, Hkv, S, T, D, causal, window, cap in FLASH_CASES:
        kw = dict(causal=causal, window=window, softcap=cap)
        for dtype in (torch.float32, torch.bfloat16):
            q = randn((B, Hq, S, D), dtype)
            k, v = randn((B, Hkv, T, D), dtype), randn((B, Hkv, T, D), dtype)
            got = flash_prefill(q, k, v, **kw)
            want = ref_flash_prefill(q, k, v, **kw)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            torch.testing.assert_close(got.float(), want.float(),
                                       atol=tol[dtype], rtol=tol[dtype])
            # rows with no visible key: exactly 0, as in the Pallas kernel
            i = torch.arange(S, device=dev)[:, None]
            j = torch.arange(T, device=dev)[None, :]
            vis = torch.ones((S, T), dtype=torch.bool, device=dev)
            if causal:
                vis &= j <= i
            if window:
                vis &= j > i - window
            blind = ~vis.any(dim=1)
            assert not got[:, :, blind].any(), "a row with no key is not 0"
            log(f"[flash_prefill] case {(B, Hq, Hkv, S, T, D)} {dtype} "
                f"{kw}: max|err| {err:.3e} (tol {tol[dtype]}); "
                f"{int(blind.sum())} rows with no visible key, all 0")

    perf = None
    for name, B, Hq, Hkv, S, T, D, dt, window, cap, qs in flash_main():
        dtype = getattr(torch, dt)
        kw = dict(window=window, softcap=cap)
        q = randn((B, S, Hq, D), dtype, qs)            # the model's layout
        k, v = randn((B, T, Hkv, D), dtype), randn((B, T, Hkv, D), dtype)
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        got = kernels.flash_attention(q, k, v, **kw)
        want = ref_flash_prefill(qh, kh, vh, **kw).transpose(1, 2)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        tol_used = (MAIN_SHAPE_FLASH_BF16_TOL if dtype == torch.bfloat16
                    else {"atol": 2e-5, "rtol": 2e-5})
        torch.testing.assert_close(got.float(), want.float(), **tol_used)
        del want
        long_seq = S > 4096
        ms = cuda_ms(lambda: kernels.flash_attention(q, k, v, **kw),
                     iters=5 if long_seq else 20, warmup=1 if long_seq else 3)
        plain = cuda_ms(lambda: ref_flash_prefill(qh, kh, vh, **kw),
                        iters=2 if long_seq else 10, warmup=1)
        lib_ms, lib_txt = None, "none (no single PyTorch call computes a "             "softcapped attention)"
        if not window and not cap:
            # torch's is_causal is aligned top-left, as the kernel's mask
            lib = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                                 enable_gqa=True)
            torch.testing.assert_close(lib.transpose(1, 2).float(),  # sanity
                                       got.float(), atol=2e-2, rtol=2e-2)
            del lib
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True, enable_gqa=True),
                iters=5 if long_seq else 20, warmup=1 if long_seq else 3)
            lib_txt = f"sdpa (is_causal, enable_gqa) {lib_ms:.4f} ms"
        bound, by, nbytes, flops = flash_bound_ms(
            B, Hq, Hkv, S, T, D, True, window, q.element_size())
        log(f"[flash_prefill] shape ({name}) B={B} S={S} T={T} Hq={Hq} "
            f"Hkv={Hkv} D={D} {dt} window {window} softcap {cap} query "
            f"scale {qs}, via kernels.flash_attention: max|err| {err:.3e}, "
            f"relative norm {rel:.3e} (tol {tol_used}); kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, {lib_txt}, bound {bound:.4f} ms by {by} "
            f"({nbytes} B, {flops} flop; {flops / ms / 1e9:.2f} TFLOP/s, "
            f"{bound / ms:.3f} of the bound) on {card}")
        if name == "a":
            perf = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                        bound_ms=bound, bound_by=by, library_ms=lib_ms)
        del q, k, v, qh, kh, vh, got
        torch.cuda.empty_cache()
    return perf


# ======================================================================
# phase 3


TOY16 = dict(name="paged-eng", arch_type="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
             dtype="float32")                  # tests/test_paged_engine.py
TOY32 = dict(TOY16, head_dim=32)


def toy_run(cfg, params, dev, **engine_kw):
    """Two turns x two models over a growing session context (copy-on-write
    tails, prefix hits); returns (greedy tokens, engine)."""
    import numpy as np

    from repro_torch.params import tree_map
    from repro_torch.serving import LocalDisaggEngine, SamplingParams

    p = {m: tree_map(lambda t: t.to(dev), t) for m, t in params.items()}
    eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"], "m1": p["m1"]},
                            device=dev, num_pages=64, page_size=8,
                            **engine_kw)
    rng = np.random.default_rng(0)
    ctx = [int(t) for t in rng.integers(4, 60, 19)]
    got = []
    for turn in range(2):
        for mid in ("m0", "m1"):
            ctx += [int(t) for t in rng.integers(4, 60, 5)]
            out = eng.generate(mid, ctx, SamplingParams(max_tokens=4),
                               session=0).result().tolist()
            got.append(out)
            ctx += out
    assert eng.stats.cow_page_copies > 0
    return got, eng


def phase_toy_engine():
    import numpy as np
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import init_params
    from repro_torch.params import tree_map
    from repro_torch.serving import LocalDisaggEngine, SamplingParams

    for kw in (TOY16, TOY32):
        cfg = ModelConfig(**kw)
        cpu = {m: init_params(cfg, s, device="cpu")
               for m, s in (("base", 0), ("m0", 10), ("m1", 11))}
        outs = {dev: toy_run(cfg, cpu, dev)[0] for dev in ("cpu", "cuda")}
        assert outs["cuda"] == outs["cpu"], outs
        log(f"[toy engine] head_dim {cfg.head_dim}: card tokens == CPU "
            f"tokens: {outs['cuda']}")
        if cfg.head_dim != 16:
            continue
        # chunked: boundaries mid-page (page 8), card == CPU == eager
        for chunk in (3, 8):
            got = {}
            for dev in ("cpu", "cuda"):
                got[dev], eng = toy_run(cfg, cpu, dev, chunked=True,
                                        chunk_size=chunk, token_budget=16)
                assert eng.scheduler.stats.chunks > 1, eng.scheduler.stats
            assert got["cuda"] == got["cpu"] == outs["cuda"], (got, outs)
            log(f"[toy engine] head_dim 16 chunked, chunk_size {chunk}: "
                f"card tokens == CPU chunked tokens == card eager tokens")

        # sentinel row 0: a ragged fused batch (two m0 rows, one m1 row)
        # has a padding row; nothing may write pool row 0
        rng = np.random.default_rng(3)
        jobs = [(list(rng.integers(4, 60, size=n)), m)
                for n, m in ((37, "m0"), (9, "m0"), (20, "m1"))]
        p = {m: tree_map(lambda t: t.to("cuda"), t) for m, t in cpu.items()}

        def engine():
            return LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"],
                                                      "m1": p["m1"]},
                                     device="cuda", num_pages=64,
                                     page_size=8)
        eng = engine()
        outs = [eng.generate(m, ctx, SamplingParams(max_tokens=5))
                for ctx, m in jobs]
        eng.run()
        assert eng.stats.decode_dispatches == eng.stats.decode_steps
        kv = eng.kvpool
        for a in (*kv.k_groups.values(), *kv.v_groups.values()):
            assert not a[:, 0].any(), "a group layer wrote sentinel row 0"
        for a in (*kv.k_tail, *kv.v_tail):
            assert not a[0].any(), "a tail layer wrote sentinel row 0"
        alone = [engine().generate(m, ctx, SamplingParams(max_tokens=5))
                 .result().tolist() for ctx, m in jobs]
        assert [o.tokens for o in outs] == alone, (outs, alone)
        torch.cuda.synchronize()
        log(f"[toy engine] head_dim 16 ragged fused batch (m0, m0, m1): "
            f"sentinel row 0 of every layer is zero; tokens == isolated "
            f"runs: {alone}")
        toy_preempt(cfg, cpu)
        toy_autoscale(cfg, cpu)


#: tests/test_preempt.py's contention fleet: 18 pages of 8, two
#: low-priority 9-token prompts decoding 40 tokens, then (after 4 steps)
#: two priority-5 17-token prompts decoding 6
TOY_ARMED = dict(preempt=True, overcommit=2.0, sanitize=True)
TOY_COUNTERS = ("preemptions", "swap_out_pages", "swap_in_pages",
                "recompute_tokens", "swap_bytes")


def toy_fleet(cfg, params, dev, mode=None, **engine_kw):
    """The contention fleet on a toy engine whose one decode model is the
    base itself; returns (tokens, preemption counters)."""
    from repro_torch.params import tree_map
    from repro_torch.serving import LocalDisaggEngine, SamplingParams

    base = tree_map(lambda t: t.to(dev), params["base"])
    eng = LocalDisaggEngine(cfg, base, device=dev, num_pages=18,
                            page_size=8, chunked=True, **engine_kw)
    eng.models.register("m", base)
    if mode is not None:
        eng.swap.cfg.mode = mode
    lo = [eng.generate("m", [2 + i] * 9, SamplingParams(max_tokens=40),
                       priority=0) for i in range(2)]
    for _ in range(4):
        eng.step()
    hi = [eng.generate("m", [30 + i] * 17, SamplingParams(max_tokens=6),
                       priority=5) for i in range(2)]
    eng.run()
    assert eng.block_pool.free_count == 18, eng.block_pool.free_count
    s = eng.stats()
    return ([h.result().tolist() for h in lo + hi],
            {k: s[k] for k in TOY_COUNTERS})


def toy_preempt(cfg, cpu):
    """The contention fleet armed (``TOY_ARMED``), forced swap and forced
    recompute: card tokens == CPU tokens == the unarmed run's, and the
    same preemption counters on both."""
    plain = {dev: toy_fleet(cfg, cpu, dev)[0] for dev in ("cpu", "cuda")}
    assert plain["cuda"] == plain["cpu"], plain
    for mode in ("swap", "recompute"):
        got = {dev: toy_fleet(cfg, cpu, dev, mode, **TOY_ARMED)
               for dev in ("cpu", "cuda")}
        assert got["cuda"][0] == got["cpu"][0] == plain["cuda"], \
            (mode, got, plain)
        assert got["cuda"][1] == got["cpu"][1], (mode, got)
        assert got["cuda"][1]["preemptions"] >= 1, (mode, got)
        log(f"[toy engine] contention fleet, preempt=True overcommit=2.0 "
            f"sanitize=True, forced {mode}: card tokens == CPU tokens == "
            f"unarmed tokens; counters {got['cuda'][1]} on both")


def toy_autoscale(cfg, cpu):
    """A long-prompt burst on engines that grow their prefill pool
    (``autoscale=``): the tokens of a fixed pool, card and CPU."""
    import numpy as np

    from repro_torch.params import tree_map
    from repro_torch.serving import (AutoscaleConfig, LocalDisaggEngine,
                                     SamplingParams)

    grow = AutoscaleConfig(interval_s=0.0, cooldown_intervals=0,
                           backlog_high_s=1e-4, shrink_patience=10_000)
    rng = np.random.default_rng(3)
    ctxs = [[int(t) for t in rng.integers(4, 60, size=48 + i)]
            for i in range(6)]
    got = {}
    for dev in ("cpu", "cuda"):
        p = {m: tree_map(lambda t: t.to(dev), t) for m, t in cpu.items()}
        for scale in (grow, None):
            eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"]},
                                    device=dev, num_pages=256, page_size=8,
                                    chunked=True, chunk_size=8,
                                    token_budget=32, autoscale=scale)
            outs = [eng.generate("m0", c, SamplingParams(max_tokens=4))
                    for c in ctxs]
            eng.run()
            got[dev, scale is not None] = [list(o.tokens) for o in outs]
            if scale is not None:
                assert len(eng.prefill_workers) > 1, eng.prefill_workers
                workers = len(eng.prefill_workers)
    assert len(set(map(str, got.values()))) == 1, got
    log(f"[toy engine] autoscale: the prefill pool grew to {workers} "
        f"workers; tokens == a fixed pool's, card and CPU")


# ======================================================================
# phase 4


def counters():
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.paged_decode import paged_decode_attention
    from repro_torch.kernels.paged_write import paged_write
    return {"paged_decode": paged_decode_attention,
            "paged_write": paged_write,
            "flash_prefill_paged": flash_prefill_paged,
            "flash_prefill": flash_prefill}


def serve_turns(eng, cfg, card, tag):
    """The main path's traffic: a shared 1000-token context, then two turns
    of 4 requests (2 per model, 32-token private tails, 32 greedy tokens
    each); the second turn's context grows by the first answer. Launch
    counters are zeroed just before and read just after. Returns
    (launches, requests, per-turn records, context prefill seconds, the
    shared context's K and V rows as ``context_kv`` reads them)."""
    import numpy as np
    import torch

    from repro_torch.launch.main_path import PROMPT_TOKENS, TAIL_TOKENS, tokens
    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(0)
    prompt = tokens(cfg, rng, PROMPT_TOKENS)
    tails = [tokens(cfg, rng, TAIL_TOKENS) for _ in range(8)]
    params = SamplingParams(max_tokens=32)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t_start = time.perf_counter()
    reqs, turns = [], []
    ctx = eng.shared_context(prompt)
    torch.cuda.synchronize()
    context_s = time.perf_counter() - t_start
    log(f"[{tag}] shared context: {len(prompt)} tokens prefilled in "
        f"{context_s:.4f} s on {card}")
    kv = context_kv(eng, ctx.session_id, len(prompt))
    with ctx:
        for turn in range(2):
            outs = [ctx.generate(m, tails[4 * turn + 2 * i + j], params)
                    for i, m in enumerate(("m0", "m1")) for j in range(2)]
            t0 = time.perf_counter()
            steps0 = eng.stats.decode_steps
            eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ntok = sum(len(o.tokens) for o in outs)
            rec = dict(tok_s=ntok / dt, ttft=[o.ttft for o in outs],
                       steps=eng.stats.decode_steps - steps0, s=dt)
            log(f"[{tag}] turn {turn}: {len(outs)} requests, {ntok} tokens "
                f"in {rec['steps']} decode steps, {dt:.3f} s -> "
                f"{rec['tok_s']:.1f} decode tok/s; TTFT s "
                f"{[round(t, 4) for t in rec['ttft']]} on {card}")
            reqs += outs
            turns.append(rec)
            ctx.extend(outs[0].tokens)         # next turn: a longer context
    launches = {n: fn.launches for n, fn in fns.items()}
    log(f"[{tag}] launches {launches}; wall "
        f"{time.perf_counter() - t_start:.3f} s")
    for o in reqs:
        assert o.finished and len(o.tokens) == 32, o
        assert all(0 <= t < cfg.vocab_size for t in o.tokens), o
    return launches, reqs, turns, context_s, kv


def context_kv(eng, sid: int, n: int):
    """Copies of the first ``n`` K and V rows of session ``sid`` in every
    layer of the pool, (n_layers, n, Hkv, D) each."""
    import torch
    bt = next(w.sessions[sid].block_table for w in eng.prefill_workers
              if sid in w.sessions)
    idx = torch.tensor(bt, dtype=torch.long, device=eng.device)

    def take(pages):
        return torch.stack([p[idx].flatten(0, 1)[:n] for p in pages])
    return tuple(take(pages) for pages in eng.kvpool.layers())


def kv_rel_err(got, want) -> list:
    """Per layer, ||K_got - K_want|| / ||K_want|| and the same for V, the
    larger of the two."""
    return [max(((a.float() - b.float()).norm() / b.float().norm()).item()
                for a, b in ((got[0][i], want[0][i]), (got[1][i], want[1][i])))
            for i in range(want[0].shape[0])]


def check_memory(eng, mem0, card, tag):
    """Peak device memory within the engine's weights (held once) and pool,
    plus what was allocated before it, plus 2 GiB of activations."""
    import torch

    from repro_torch.launch.main_path import resident_bytes
    peak = torch.cuda.max_memory_allocated()
    held = resident_bytes(eng)
    log(f"[{tag}] max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); "
        f"weights + pool {held} B ({held / 2**30:.2f} GiB); allocated "
        f"before {mem0} B on {card}")
    assert peak <= mem0 + held + PEAK_SLACK_BYTES, (peak, mem0, held)


def report_metrics(eng, card, tag):
    """TTFT and ITL p50/p95 from ``engine.metrics()``, and the Prometheus
    exposition held to ``metrics.lint_prometheus``."""
    from repro_torch.serving.metrics import lint_prometheus
    h = eng.metrics()["histograms"]
    parts = []
    for name in ("engine_ttft_seconds", "engine_itl_seconds"):
        x = h[name]
        assert x["count"] > 0, (name, x)
        parts.append(f"{name} n={x['count']} p50 {x['p50']:.6f} s p95 "
                     f"{x['p95']:.6f} s")
    problems = lint_prometheus(eng.render_prometheus())
    assert problems == [], problems
    log(f"[{tag}] metrics: {'; '.join(parts)}; render_prometheus lints "
        f"clean on {card}")


def phase_main_path(card, n_layers: int):
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.main_path import MODEL, build_engine

    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    cfg, eng = build_engine(n_layers)
    torch.cuda.synchronize()
    full = get_config(MODEL).n_layers
    if cfg.n_layers != full:
        log(f"[main] depth cut: n_layers {full} -> {cfg.n_layers} (width "
            f"unchanged)")
    log(f"[main] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; base + 2 decoders + 2048x16 pool "
        f"ready in {time.perf_counter() - t:.2f} s")
    free0 = eng.block_pool.free_count
    launches, reqs, turns, context_s, kv = serve_turns(eng, cfg, card,
                                                       "main")

    s = eng.stats()
    log(f"[main] stats {json.dumps(s)}")
    assert s["prefill_tokens_reused"] > 0, s
    assert s["cow_page_copies"] > 0, s
    assert launches["paged_decode"] == cfg.n_layers * s["decode_dispatches"], \
        (launches, s)
    assert s["decode_dispatches"] == s["decode_steps"], s
    assert launches["paged_write"] > 0, launches
    assert launches["flash_prefill_paged"] == 0, launches   # eager prefill
    assert launches["flash_prefill"] == 0, launches   # not on the engine
    assert eng.block_pool.free_count == free0, (eng.block_pool.free_count,
                                                free0)
    eng.block_pool.check_invariants()
    check_memory(eng, mem0, card, "main")
    report_metrics(eng, card, "main")
    # no request handle is kept: each holds the engine, whose pool phase 5
    # frees
    return launches, dict(engine=eng, cfg=cfg, turns=turns,
                          context_s=context_s, kv=kv,
                          tokens=[list(o.tokens) for o in reqs])


def phase_kernel_api(card, eager: dict):
    """The kernel API's path at full width over phase 4's base weights:
    layer 0's post-RoPE q/k/v of the shared 1000-token context (the
    engine's own projections, ``models.attention.project_qkv``) through
    ``repro_torch.kernels.flash_attention``, with every launch counter
    zeroed just before and read just after. The result is held to
    ``MAIN_SHAPE_FLASH_BF16_TOL`` against the port's dense
    ``models.attention.attention`` on the same q/k/v at positions
    0..S-1, run in fp32 and rounded once to bf16 as the kernel is; the
    bf16 run of ``attention``, which rounds q * scale to bf16 before its
    product, is printed beside it, not asserted. Returns the launches."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.ref import MAIN_SHAPE_FLASH_BF16_TOL
    from repro_torch.launch.main_path import PROMPT_TOKENS, tokens
    from repro_torch.models.attention import attention, project_qkv
    from repro_torch.models.layers import rmsnorm
    from repro_torch.models.model import _embed, _layers

    cfg, base = eager["cfg"], eager["engine"].base_params
    prompt = tokens(cfg, np.random.default_rng(0), PROMPT_TOKENS)  # phase 4's
    dev = torch.device("cuda")
    toks = torch.tensor([prompt], device=dev)
    pos = torch.arange(len(prompt), dtype=torch.int32, device=dev)[None]
    lp, _ = next(_layers(cfg, base, None))
    h = rmsnorm(_embed(cfg, base["embed"], toks), lp["norm1"], cfg.norm_eps)
    q, k, v = project_qkv(lp["attn"], h, cfg, pos)
    torch.cuda.synchronize()
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    got = kernels.flash_attention(q, k, v, softcap=cfg.attn_softcap or 0.0)
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    want = attention(q.float(), k.float(), v.float(), pos, pos,
                     softcap=cfg.attn_softcap).to(q.dtype)
    bf16 = attention(q, k, v, pos, pos, softcap=cfg.attn_softcap)
    err = (got.float() - want.float()).abs().max().item()
    err16 = (got.float() - bf16.float()).abs().max().item()
    log(f"[kernel api] {cfg.name} layer 0, shared context of {len(prompt)} "
        f"tokens: q {tuple(q.shape)} k/v {tuple(k.shape)} {q.dtype}; "
        f"launches {launches}; kernels.flash_attention vs "
        f"models.attention.attention in fp32 on the same q/k/v: max|err| "
        f"{err:.3e} (tol {MAIN_SHAPE_FLASH_BF16_TOL}); vs attention in bf16 "
        f"(q * scale rounded to bf16 first; not asserted): max|err| "
        f"{err16:.3e}")
    torch.testing.assert_close(got.float(), want.float(),
                               **MAIN_SHAPE_FLASH_BF16_TOL)
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    assert launches["flash_prefill"] == 1, launches
    assert sum(launches.values()) == 1, launches
    return launches


# ======================================================================
# phase 5


def phase_chunked(card, eager: dict):
    import gc

    import torch

    from repro_torch.launch.main_path import CHUNKED, rebuild_engine

    cfg = eager["cfg"]
    old = eager.pop("engine")
    eng = rebuild_engine(old, **CHUNKED)       # same weight tensors
    del old                                    # frees phase 4's pool
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(f"[chunked] {cfg.name}: {cfg.n_layers} layers over the same weights, "
        f"fresh 2048x16 pool; {CHUNKED}")
    free0 = eng.block_pool.free_count
    launches, reqs, turns, context_s, kv = serve_turns(eng, cfg, card,
                                                       "chunked")
    log(f"[chunked] shared context prefill vs eager (same call): "
        f"{context_s:.4f} s vs {eager['context_s']:.4f} s on {card}")
    for t, (c, e) in enumerate(zip(turns, eager["turns"])):
        # decode tok/s: tokens over the wall of run(), which in chunked
        # mode also holds the tails' chunk forward
        log(f"[chunked] turn {t} vs eager (same call): decode tok/s "
            f"{c['tok_s']:.1f} vs {e['tok_s']:.1f}; TTFT s "
            f"{[round(x, 4) for x in c['ttft']]} vs "
            f"{[round(x, 4) for x in e['ttft']]} on {card}")

    s = eng.stats()
    st = eng.scheduler.stats
    log(f"[chunked] stats {json.dumps(s)}; scheduler {st}")
    assert s["prefill_tokens_reused"] > 0, s
    assert st.chunks > 1 and st.max_prefill_batch >= 2, st
    # the chunk forwards are the shapes phase 2 held against the plain version
    assert st.chunks == sum(B for B, _, _ in MAIN_CHUNKS), (st, MAIN_CHUNKS)
    assert st.chunk_tokens == sum(B * S for B, S, _ in MAIN_CHUNKS), st
    n_prefill = launches["flash_prefill_paged"]
    assert n_prefill > 0 and n_prefill % cfg.n_layers == 0, launches
    assert launches["paged_write"] == 0, launches     # no eager prefill
    assert launches["paged_decode"] == cfg.n_layers * s["decode_dispatches"], \
        (launches, s)
    assert s["decode_dispatches"] == s["decode_steps"] > 0, s
    assert eng.block_pool.free_count == free0, (eng.block_pool.free_count,
                                                free0)
    eng.block_pool.check_invariants()
    check_memory(eng, 0, card, "chunked")
    same = sum(a == b for c, e in zip(reqs, eager["tokens"])
               for a, b in zip(c.tokens, e))
    total = sum(len(e) for e in eager["tokens"])
    rel = kv_rel_err(kv, eager.pop("kv"))
    log(f"[chunked] shared context K/V, chunked vs eager, relative norm per "
        f"layer (bf16; ceiling (layer + 1) * 2**-8; phase 6 holds the same "
        f"path in fp32): {[f'{r:.3e}' for r in rel]}")
    # a loose ceiling, not a tolerance: each layer rounds its activations
    # to bf16 (2**-8 relative at most) on either path, so the difference
    # may grow by about that much per layer; a wrong key or page shows in
    # fp32 (phase 6), far below rounding noise here
    assert all(r <= (i + 1) * 2 ** -8 for i, r in enumerate(rel)), rel
    log(f"[chunked] greedy tokens equal to the eager run's: {same} of "
        f"{total} (not asserted)")
    report_metrics(eng, card, "chunked")
    eager["base"] = eng.base_params            # phase 9's base, held once
    # phase 18 sets the cost model beside the chunk forwards timed here
    eager["chunked_context_s"], eager["chunked_turns"] = context_s, turns
    # phase 11's weights: the stacked decoders (phase 9 frees them)
    eager["decoders"] = {m: dw.spec.full for m, dw in eng.decoders.items()}
    return launches


# ======================================================================
# phase 6


#: phase 6's depth cut and its bound on the per-layer relative norm of the
#: chunked minus the eager context K/V in fp32: a dot product of n = 4096
#: terms rounds by at most n * 2**-24 ~ 2.4e-4 relative, typically
#: sqrt(n) * 2**-24 ~ 4e-6; a chunk start off by one (each query sees one
#: key too many or too few) gives ~9e-2 at a narrow width
FP32_LAYERS = 4
FP32_KV_REL = 1e-4


def phase_fp32_parity(card, n_layers: int):
    """The chunked and the eager path at full width in fp32, depth cut:
    identical greedy tokens, and context K/V within FP32_KV_REL per layer.
    Same traffic, page size, chunk shapes and table widths as phase 5."""
    import gc

    import torch

    from repro_torch.launch.main_path import (CHUNKED, build_engine,
                                              rebuild_engine)

    gc.collect()
    torch.cuda.empty_cache()
    cfg, eng = build_engine(n_layers, dtype="float32")
    log(f"[fp32] {cfg.name}: {cfg.n_layers} layers (depth cut), d_model "
        f"{cfg.d_model}, {cfg.dtype}; eager, then chunked over the same "
        f"weights")
    e_launches, e_reqs, _, _, e_kv = serve_turns(eng, cfg, card, "fp32 eager")
    e_tokens = [list(o.tokens) for o in e_reqs]
    del e_reqs
    old, eng = eng, rebuild_engine(eng, **CHUNKED)
    del old
    gc.collect()
    torch.cuda.empty_cache()
    c_launches, c_reqs, _, _, c_kv = serve_turns(eng, cfg, card,
                                                 "fp32 chunked")
    assert e_launches["paged_write"] > 0, e_launches
    assert e_launches["flash_prefill_paged"] == 0, e_launches
    assert c_launches["paged_write"] == 0, c_launches
    assert c_launches["flash_prefill_paged"] > 0, c_launches
    rel = kv_rel_err(c_kv, e_kv)
    log(f"[fp32] shared context K/V, chunked vs eager, relative norm per "
        f"layer: {[f'{r:.3e}' for r in rel]} (bound {FP32_KV_REL})")
    assert max(rel) <= FP32_KV_REL, rel
    c_tokens = [list(o.tokens) for o in c_reqs]
    assert c_tokens == e_tokens, (c_tokens, e_tokens)
    log(f"[fp32] chunked greedy tokens == eager greedy tokens: all "
        f"{sum(map(len, c_tokens))}")
    decs = {m: dw.spec.full for m, dw in eng.decoders.items()}
    del eng, c_reqs
    fp32_preempt(card, cfg, decs)


def fp32_preempt(card, cfg, decs):
    """Phase 11's fleet in fp32 at phase 6's depth, greedy and seeded:
    forced swap and forced recompute give the tokens of the unarmed run."""
    for seeded in (False, True):
        want = preempt_run(cfg, decs, decs["m0"]["embed"].device, "off",
                           seeded)["tokens"]
        for mode in ("swap", "recompute"):
            r = preempt_run(cfg, decs, decs["m0"]["embed"].device, mode,
                            seeded)
            assert r["tokens"] == want, (mode, seeded)
            log(f"[fp32] preemption fleet, {'seeded' if seeded else 'greedy'}"
                f", forced {mode}: {r['stats']['preemptions']} preemptions "
                f"(modes {r['modes']}), tokens == the unarmed run's: all "
                f"{sum(map(len, want))}")


# ======================================================================
# phase 7


def phase_device_times(card, lora):
    """Device time (``device_ms``) of the tensor-core kernels at the main
    shapes: ``paged_decode`` at both DECODE_SHAPES and ``flash_prefill_paged``
    at every MAIN_CHUNKS forward, each beside SDPA on pre-gathered dense
    K/V, dense ``flash_prefill`` at ``flash_main()``'s bf16 shapes. Then the
    slice's plain-torch parts: the sampler on logits of phase 8's step
    (what it adds to that step's device time) beside argmax, and one
    decode step's LoRA merge over phase 9's base and adapters (``lora``),
    in all and by kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
    from repro_torch.kernels.paged_decode import paged_decode_attention
    from repro_torch.launch.timing import device_ms

    from repro_torch.launch.main_path import MOE_MODEL

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    gr = config_heads(MOE_MODEL)
    granite = (gr["Hq"], gr["Hkv"], gr["D"], gr["page"])
    llama = (32, 8, 128, 16)
    for label, name, heads in (("", "main", llama), ("", "engine", llama),
                               ("granite-moe ", "engine", granite)):
        q, kp, vp, bt, ln = decode_shape_inputs(name, g, heads)
        ms = device_ms(lambda: paged_decode_attention(q, kp, vp, bt, ln))
        kd, vd, mask, qg = decode_sdpa_inputs(q, kp, vp, bt, ln)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qg, kd, vd, attn_mask=mask))
        log(f"[device time] paged_decode {label}{name} shape B={q.shape[0]} "
            f"Hq={heads[0]} Hkv={heads[1]} D={heads[2]} "
            f"npages={bt.shape[1]} bf16: kernel (with its merge) "
            f"{fmt_ms(ms)}, sdpa on pre-gathered dense K/V {fmt_ms(lib)} "
            f"(torch.profiler, mean of 20 calls) on {card}")
        del q, kp, vp, kd, vd
    P = 2049
    for label, (Hq, Hkv, D, page), (B, S, st0) in (
            [("", llama, c) for c in MAIN_CHUNKS]
            + [("granite-moe ", granite, c)
               for c in ((1, 200, 800), (4, 40, 992))]):
        G = Hq // Hkv
        bt = torch.tensor(chunk_table(B, S, st0, page, P, 4),
                          dtype=torch.int32, device=dev)
        T = bt.shape[1] * page
        q = torch.randn((B, S, Hq, D), generator=g, device=dev).bfloat16()
        kp, vp = (torch.randn((P, page, Hkv, D), generator=g,
                              device=dev).bfloat16() for _ in range(2))
        start = torch.full((B,), st0, dtype=torch.int32, device=dev)
        ms = device_ms(lambda: flash_prefill_paged(q, kp, vp, bt, start))
        kd, vd = (x[bt.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3)
                  .contiguous() for x in (kp, vp))
        qd = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4).reshape(
            B, Hkv, G * S, D).contiguous()
        qpos = (start[:, None] + torch.arange(S, device=dev)[None]).repeat(
            1, G)
        mask = (torch.arange(T, device=dev)[None, None]
                <= qpos[:, :, None])[:, None]
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask))
        log(f"[device time] flash_prefill_paged {label}B={B} S={S} start "
            f"{st0} Hq={Hq} Hkv={Hkv} D={D} bf16: kernel {fmt_ms(ms)}, sdpa "
            f"on pre-gathered dense K/V "
            f"{fmt_ms(lib)} (torch.profiler, mean of 20 calls) on {card}")
        del q, kp, vp, kd, vd, qd, mask
    for name, B, Hq, Hkv, S, T, D, dt, window, cap, qs in flash_main():
        if dt != "bfloat16":
            continue
        q = (torch.randn((B, S, Hq, D), generator=g, device=dev)
             * qs).bfloat16()
        k, v = (torch.randn((B, T, Hkv, D), generator=g,
                            device=dev).bfloat16() for _ in range(2))
        ms = device_ms(lambda: kernels.flash_attention(
            q, k, v, window=window, softcap=cap), iters=5 if S > 4096 else 20)
        log(f"[device time] flash_prefill shape ({name}) S={S} T={T} "
            f"Hq={Hq} Hkv={Hkv} window {window} softcap {cap} bf16: kernel "
            f"{fmt_ms(ms)} (torch.profiler) on {card}")
        del q, k, v
    torch.cuda.empty_cache()
    slice6_device_times(card, lora)


def slice6_device_times(card, lora):
    """Phase 7's times of the sampler and of the LoRA merge."""
    import torch

    from repro_torch.core.lora import lora_lanes
    from repro_torch.launch.timing import device_ms
    from repro_torch.models.model import _layers
    from repro_torch.serving.sampling import sample_step

    cfg = lora["cfg"]
    dev = lora["base"]["embed"].device
    g = torch.Generator(device=dev).manual_seed(3)
    lg = torch.randn((4, cfg.vocab_size), generator=g, device=dev) * 3
    rows = (torch.full((4,), 1000, dtype=torch.int32, device=dev),
            torch.full((4,), SAMPLED["temperature"], device=dev),
            torch.full((4,), SAMPLED["top_k"], dtype=torch.int32, device=dev),
            torch.full((4,), SAMPLED["top_p"], device=dev),
            torch.arange(1, 5, dtype=torch.int32, device=dev))
    t = {name: (cuda_ms(fn), device_ms(fn)) for name, fn in (
        ("sample_step", lambda: sample_step(lg, *rows)),
        ("argmax", lambda: lg.argmax(-1)))}
    log(f"[device time] sampler on (4, {cfg.vocab_size}) fp32 logits "
        f"({SAMPLED}): sample_step device {fmt_ms(t['sample_step'][1])}, "
        f"CUDA events {fmt_ms(t['sample_step'][0])} (mean of 20); argmax "
        f"device {fmt_ms(t['argmax'][1])}, events {fmt_ms(t['argmax'][0])} "
        f"on {card}")

    layers = list(zip(_layers(cfg, lora["base"], None),
                      _layers(cfg, lora["ab"], None, axis=1)))
    scale = LORA_ALPHA / LORA_RANK

    def merge():
        # one layer's lanes at a time, as in the step
        for (lp, _), (ab, _) in layers:
            lora_lanes(lp, ab, scale)
    ms, ev = device_ms(merge, iters=3), cuda_ms(merge, iters=3, warmup=1)
    top = device_kernels(merge)
    log(f"[device time] LoRA merge of one decode step ({cfg.n_layers} "
        f"layers x {len(LORA_MODELS)} lanes x wq/wv/wo, bf16): device "
        f"{fmt_ms(ms)} (torch.profiler), {fmt_ms(ev)} by CUDA events; by "
        f"kernel, device ms: "
        f"{'; '.join(f'{n[:60]} {k:.3f} x{c}' for n, k, c in top)} on "
        f"{card}")


# ======================================================================
# phase 8: sampled requests at full width (run after phase 4)


#: the sampled requests' controls (the seeds are the phase's own)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.9)
SAMPLED_SEEDS = {"m0": 1234, "m1": 5678}
SAMPLED_TOKENS = 32


def sampled_traffic(cfg):
    """Phase 4's shared context and turn-0 greedy tails (m0: tails[0],
    m1: tails[2]), and one private tail per seeded request."""
    import numpy as np

    from repro_torch.launch.main_path import PROMPT_TOKENS, TAIL_TOKENS, tokens
    rng = np.random.default_rng(0)                 # serve_turns' draws
    prompt = tokens(cfg, rng, PROMPT_TOKENS)
    tails = [tokens(cfg, rng, TAIL_TOKENS) for _ in range(8)]
    rng = np.random.default_rng(1)
    own = {m: tokens(cfg, rng, TAIL_TOKENS) for m in SAMPLED_SEEDS}
    return prompt, {"m0": tails[0], "m1": tails[2]}, own


def fresh_engine(eager):
    """Phase 4's weights in a new engine with a fresh pool (an empty
    prefix cache, so every request prefills exactly as in phase 4); the
    old engine and its pool are dropped."""
    import gc

    import torch

    from repro_torch.launch.main_path import rebuild_engine
    old = eager.pop("engine")
    eng = rebuild_engine(old)
    del old
    gc.collect()
    torch.cuda.empty_cache()
    eager["engine"] = eng
    return eng


def phase_sampled(card, eager):
    """Seeded sampled requests (``SAMPLED``) on phase 4's weights, each
    served twice: alone, then packed with a greedy request and a sampled
    request of each model (a batch of phase 4's turn-0 shape: two models,
    two rows each). Sampled tokens must be identical across the packings,
    and the packed greedy rows must equal phase 4's greedy tokens. A
    ``seed=None`` request draws with its request id as seed. Prints the
    time the sampler adds to a decode step of the packed batch (same step,
    every row greedy) by CUDA events; its device time is phase 7's."""
    import dataclasses

    import torch

    from repro_torch.serving import SamplingParams

    cfg = eager["cfg"]
    prompt, greedy_tails, own = sampled_traffic(cfg)

    def sp(seed):
        return SamplingParams(max_tokens=SAMPLED_TOKENS, seed=seed, **SAMPLED)
    eng = fresh_engine(eager)
    alone = {}
    with eng.shared_context(prompt) as ctx:
        for m, seed in SAMPLED_SEEDS.items():
            alone[m] = ctx.generate(m, own[m], sp(seed)).result().tolist()
        anon = ctx.generate("m0", own["m0"], sp(None))
        anon_toks = anon.result().tolist()
    assert anon.params.seed == anon.request_id, anon.params
    assert anon_toks != alone["m0"], "seed=None drew the seeded stream"
    log(f"[sampled] {SAMPLED}, {SAMPLED_TOKENS} tokens each, alone: "
        f"{ {m: t[:8] for m, t in alone.items()} } ...; seed=None request "
        f"drew with seed {anon.params.seed} (its request id)")

    eng = fresh_engine(eager)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    steps0 = eng.stats.decode_steps
    with eng.shared_context(prompt) as ctx:
        outs = {}
        for m in SAMPLED_SEEDS:
            outs["g" + m] = ctx.generate(m, greedy_tails[m],
                                         SamplingParams(max_tokens=32))
            outs["s" + m] = ctx.generate(m, own[m], sp(SAMPLED_SEEDS[m]))
        for _ in range(4):
            eng.step()
        # the added device time of sampling: this batch's next step, then
        # the same step with every row greedy (the KV writes repeat the
        # step's own, so the run goes on unchanged)
        seqs = list(eng.scheduler.active)
        eng._grow_tail_pages(seqs)
        greedy = [dataclasses.replace(s, params=SamplingParams(seed=0))
                  for s in seqs]
        plane = eng.decode_plane
        assert len(seqs) == 4 and len(plane.groups) == 1
        t = {name: cuda_ms(lambda: plane.groups[0].step(batch), iters=5,
                           warmup=1)
             for name, batch in (("sampled", seqs), ("greedy", greedy))}
        eng.run()
    launches = {n: fn.launches for n, fn in fns.items()}
    for m in SAMPLED_SEEDS:
        assert outs["s" + m].tokens == alone[m], (m, outs["s" + m].tokens,
                                                  alone[m])
    g_ref = {"m0": eager["tokens"][0], "m1": eager["tokens"][2]}
    for m in SAMPLED_SEEDS:
        assert outs["g" + m].tokens == g_ref[m], (m, outs["g" + m].tokens,
                                                  g_ref[m])
    s = eng.stats()
    assert launches["paged_decode"] >= cfg.n_layers * (s["decode_steps"]
                                                       - steps0), launches
    log(f"[sampled] packed with a greedy request of each model: sampled "
        f"tokens == alone; greedy rows == phase 4's tokens; launches "
        f"{launches} on {card}")
    log(f"[sampled] decode step of the packed batch (B=4, vocab "
        f"{cfg.vocab_size}): sampled {fmt_ms(t['sampled'])} / all-greedy "
        f"{fmt_ms(t['greedy'])} by CUDA events (mean of 5, host launches "
        f"included): the sampler adds {fmt_ms(t['sampled'] - t['greedy'])} "
        f"on {card}")
    torch.cuda.synchronize()


# ======================================================================
# phase 9: four LoRA decode models over the base (run after phase 5)


LORA_MODELS = ("l0", "l1", "l2", "l3")
LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_B_SCALE = 0.01                    # B ~ N(0, 1) * this (nonzero)
LORA_TOKENS = 16


def lora_adapters(base, seed: int):
    """``lora_init`` adapters (rank 16, wq/wv/wo) for ``LORA_MODELS``, with
    B drawn nonzero, all from one seeded generator on the base's device."""
    import torch

    from repro_torch.core.lora import LoRAPair, lora_init
    from repro_torch.serving import LoRAAdapter

    dev = base["embed"].device
    g = torch.Generator(device=dev).manual_seed(seed)

    def nonzero_b(pair):
        b = torch.randn(pair.B.shape, generator=g, device=dev)
        return LoRAPair(pair.A, (b * LORA_B_SCALE).to(pair.B.dtype))
    ads = {}
    for m in LORA_MODELS:
        tree = lora_init(base, rank=LORA_RANK, generator=g)
        ads[m] = LoRAAdapter(_map_pairs(nonzero_b, tree), alpha=LORA_ALPHA,
                             rank=LORA_RANK)
    return ads


def _map_pairs(fn, node):
    from repro_torch.core.lora import LoRAPair
    if isinstance(node, LoRAPair):
        return fn(node)
    if isinstance(node, dict):
        return {k: _map_pairs(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_map_pairs(fn, v) for v in node]
    return node


def lora_serve(eng, cfg, sampled_models=("l1", "l3")):
    """Phase 4's shared context, one request per LoRA model (32-token
    tails), greedy for two models and sampled for the other two; returns
    the tokens per model."""
    import numpy as np

    from repro_torch.launch.main_path import PROMPT_TOKENS, TAIL_TOKENS, tokens
    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(0)
    prompt = tokens(cfg, rng, PROMPT_TOKENS)
    rng = np.random.default_rng(2)
    with eng.shared_context(prompt) as ctx:
        outs = {m: ctx.generate(m, tokens(cfg, rng, TAIL_TOKENS),
                                SamplingParams(max_tokens=LORA_TOKENS,
                                               seed=11 + i,
                                               **(SAMPLED if m in
                                                  sampled_models else {})))
                for i, m in enumerate(LORA_MODELS)}
        eng.run()
    return {m: o.tokens for m, o in outs.items()}


def device_kernels(fn, top: int = 8):
    """One call of ``fn`` under torch.profiler: its kernels' device time
    summed by name, the ``top`` largest as (name, ms, launches)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            ms, n = by.get(ev.name, (0.0, 0))
            by[ev.name] = (ms + ev.time_range.elapsed_us() / 1e3, n + 1)
    return sorted(((k, ms, n) for k, (ms, n) in by.items()),
                  key=lambda r: -r[1])[:top]


def phase_lora(card, eager):
    """Four LoRA decode models (rank 16, alpha 32, wq/wv/wo, seeded nonzero
    B) over phase 4's base at full width and depth, after the full
    decoders and phase 5's pool are gone: one fused dispatch per step, peak
    memory within the base held once, the adapters, the pool, one layer's
    merged weights for the four lanes and 2 GiB. Prints the plane's
    ``param_bytes`` beside four full decoders' bytes and the step's wall
    time. Returns the base and the stacked adapters, with which phase 7
    times one step's merge."""
    import gc

    import torch

    from repro_torch.launch.main_path import (NUM_PAGES, PAGE_SIZE,
                                              resident_bytes)
    from repro_torch.models.model import _layers
    from repro_torch.params import tree_leaves
    from repro_torch.serving import DecodeModelSpec, LocalDisaggEngine

    cfg, base = eager["cfg"], eager.pop("base")
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    base_bytes = sum(x.nbytes for x in tree_leaves(base))
    ads = lora_adapters(base, 7)
    eng = LocalDisaggEngine(cfg, base, device=base["embed"].device,
                            num_pages=NUM_PAGES, page_size=PAGE_SIZE)
    for m, ad in ads.items():
        eng.models.register(m, DecodeModelSpec(lora=ad))
    eng.models.sync()
    plane = eng.decode_plane
    assert len(plane.groups) == 1 and plane.groups[0].lora
    (group,) = plane.groups
    lp, _ = next(_layers(cfg, base, None))
    merged_layer = len(LORA_MODELS) * sum(
        lp["attn"][k].nbytes for k in ("wq", "wv", "wo"))
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = lora_serve(eng, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in fns.items()}
    s = eng.stats()
    assert s["decode_dispatches"] == s["decode_steps"] > 0, s
    assert launches["paged_decode"] == cfg.n_layers * s["decode_steps"], \
        (launches, s)
    assert s["relay_publishes"] == 0 and s["relay_skipped"] == 4, s
    for m, toks in got.items():
        assert len(toks) == LORA_TOKENS, (m, toks)
        assert all(0 <= t < cfg.vocab_size for t in toks), (m, toks)
    peak = torch.cuda.max_memory_allocated()
    held = resident_bytes(eng)                 # base + adapters + pool
    log(f"[lora] {len(LORA_MODELS)} LoRA decoders (rank {LORA_RANK}, alpha "
        f"{LORA_ALPHA}, wq/wv/wo) over {cfg.name} {cfg.n_layers} layers "
        f"{cfg.dtype}: {s['decode_steps']} fused steps, one dispatch each, "
        f"{wall:.3f} s; launches {launches}; plane param_bytes "
        f"{plane.param_bytes()} B beside {len(LORA_MODELS)} full decoders' "
        f"{len(LORA_MODELS) * base_bytes} B; tokens "
        f"{ {m: t[:6] for m, t in got.items()} } ... on {card}")
    log(f"[lora] max_memory_allocated {peak} B; base + adapters + pool "
        f"{held} B; one layer's merged weights for {len(LORA_MODELS)} lanes "
        f"{merged_layer} B; allocated before (the base) {mem0} B")
    assert plane.param_bytes() == sum(
        x.nbytes for ad in ads.values() for x in tree_leaves(ad.params))
    assert peak <= mem0 - base_bytes + held + merged_layer \
        + PEAK_SLACK_BYTES, (peak, mem0, held, merged_layer)

    log(f"[lora] a LoRA decode step took "
        f"{fmt_ms(1e3 * wall / s['decode_steps'])} of wall time on average "
        f"(prefills included) on {card}")
    # the base and the adapters stay for phase 7's device time of a merge;
    # phase 18 times a relayout of this plane, then drops the engine
    return dict(cfg=cfg, base=base, ab=group.stacked["ab"], engine=eng)


# ======================================================================
# phase 10: the LoRA identity at 4 layers, full width, fp32 and bf16


def phase_lora_identity(card, n_layers: int):
    """Four LoRA decode models at full width, depth cut, in fp32 and bf16:
    tokens of the fused LoRA group (in-step merge) == the all-full plane
    given the ``lora_apply`` trees, and in fp32 == the per-model path
    (``fused=False``, lazily materialized ``lora_apply``); greedy and
    sampled."""
    import dataclasses
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.lora import lora_apply
    from repro_torch.launch.main_path import MODEL, NUM_PAGES, PAGE_SIZE
    from repro_torch.models import init_params
    from repro_torch.serving import DecodeModelSpec, LocalDisaggEngine

    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(MODEL), n_layers=n_layers,
                                  dtype=dtype)
        base = init_params(cfg, 0)
        ads = lora_adapters(base, 8)
        got = {}
        for mode in ("lora", "per-model", "full"):
            eng = LocalDisaggEngine(cfg, base, device=base["embed"].device,
                                    num_pages=NUM_PAGES, page_size=PAGE_SIZE,
                                    fused=mode != "per-model")
            for m, ad in ads.items():
                spec = (DecodeModelSpec(lora=ad) if mode != "full" else
                        DecodeModelSpec(full=lora_apply(
                            base, ad.params, alpha=ad.alpha, rank=ad.rank)))
                eng.models.register(m, spec)
            got[mode] = lora_serve(eng, cfg)
            if mode == "lora":
                assert eng.decoders["l0"]._dec_params is None
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        n = sum(map(len, got["lora"].values()))
        # the in-step merge is bit-equal to lora_apply: the LoRA group and
        # the all-full plane run the same fused step on the same weights
        assert got["lora"] == got["full"], got
        same = sum(a == b for m in LORA_MODELS
                   for a, b in zip(got["lora"][m], got["per-model"][m]))
        if dtype == "float32":
            assert same == n, got
        log(f"[lora {dtype}] {cfg.name} {n_layers} layers: fused LoRA group "
            f"tokens == all-full plane of the materialized trees: all {n}, "
            f"greedy and sampled; == fused=False (lora_apply, one forward "
            f"per model): {same} of {n}"
            + ("" if dtype == "float32" else
               " (not asserted in bf16: the per-model step's products have "
               "other row and lane counts than the fused step's, which "
               "cuBLAS rounds differently)"))
        del base, ads
        gc.collect()
        torch.cuda.empty_cache()


# ======================================================================
# phase 12: MoE on the paged main path at full width and depth


class DropProbe:
    """Records the ``aux`` that ``forward`` returns to every base prefill
    (eager and chunked) while open, as device scalars (no sync): the
    ``forward`` that ``core.prefillshare`` calls is wrapped, and restored by
    ``close``. ``n_moe`` MoE layers share the summed ``dropped_frac``."""

    def __init__(self, n_moe: int):
        import repro_torch.core.prefillshare as ps
        self.mod, self.orig, self.n_moe = ps, ps.forward, n_moe
        self.calls = []

        def probe(cfg, params, tokens, **kw):
            out, cache, aux = self.orig(cfg, params, tokens, **kw)
            self.calls.append((tuple(tokens.shape),
                               aux["dropped_frac"].detach()))
            return out, cache, aux
        ps.forward = probe

    def close(self) -> dict:
        """Per prefill forward shape (B, S): the dropped fraction, mean over
        the MoE layers and the forwards of that shape, and how many
        forwards had it."""
        self.mod.forward = self.orig
        by = {}
        for shape, frac in self.calls:
            by.setdefault(shape, []).append(float(frac) / self.n_moe)
        return {f"B={b} S={n}": (sum(v) / len(v), len(v))
                for (b, n), v in by.items()}


#: the fp32 card == CPU check's traffic (phases 12 and 13), small enough
#: for the CPU at full width: a context of FP32_PROMPT tokens, then two
#: turns, each a FP32_TAIL-token tail and FP32_GEN greedy tokens per model
FP32_PROMPT, FP32_TAIL, FP32_GEN = 300, 8, 6


def paged_small_turns(eng, cfg):
    """The fp32 check's traffic on a paged engine: one shared context, two
    turns of one request per model. Returns the tokens."""
    import numpy as np

    from repro_torch.launch.main_path import tokens
    from repro_torch.serving import SamplingParams
    rng = np.random.default_rng(1)
    out = []
    with eng.shared_context(tokens(cfg, rng, FP32_PROMPT)) as ctx:
        for _ in range(2):
            reqs = [ctx.generate(m, tokens(cfg, rng, FP32_TAIL),
                                 SamplingParams(max_tokens=FP32_GEN))
                    for m in ("m0", "m1")]
            eng.run()
            out += [list(r.tokens) for r in reqs]
    return out


#: output-projection scale of the fp32 card == CPU checks' weights (phases
#: 12-13; tied-embedding configs only). At ``main_path.OUT_SCALE`` (16) a
#: random 2-4 layer model can answer one token throughout, so a token check
#: could pass on a constant; each check prints its distinct tokens
FP32_OUT_SCALE = 256.0
#: the fewest distinct greedy tokens an fp32 token check accepts
FP32_MIN_DISTINCT = 3


def card_and_cpu(model, n_layers):
    """fp32 weights at full width, depth ``n_layers``, built on the card
    (two decoders stacked, row 1 also the base; output projections at
    ``FP32_OUT_SCALE``) and copied to the CPU:
    ``{device: (cfg, base, {"m0", "m1"})}``."""
    import torch

    from repro_torch.core.lora import unstack_params
    from repro_torch.launch.main_path import (OUT_SCALE, build_weights,
                                              scale_outputs)
    from repro_torch.params import tree_map
    cfg, base, stacked = build_weights(model, n_layers, None, "float32")
    del base                                  # row 1 serves as the base
    if cfg.tie_embeddings:                    # build_weights gave OUT_SCALE
        scale_outputs(stacked, FP32_OUT_SCALE / OUT_SCALE)
    out = {}
    for dev, st in (("cuda", stacked),
                    ("cpu", tree_map(lambda x: x.cpu(), stacked))):
        m0, m1 = unstack_params(st, 2)
        out[dev] = (cfg, m1, {"m0": m0, "m1": m1})
    torch.cuda.synchronize()
    return out


def fp32_logits(card, tag, both):
    """The base model's last logits over the fp32 check's context, card
    against CPU, within 1e-3 (fp32 at full width; TF32 is off), so that the
    token checks do not rest on greedy tokens alone."""
    import numpy as np
    import torch

    from repro_torch.launch.main_path import tokens
    from repro_torch.models import forward, init_cache
    cfg = both["cpu"][0]
    toks = tokens(cfg, np.random.default_rng(1), FP32_PROMPT)
    got = {}
    for dev, (_, base, _) in both.items():
        d = base["embed"].device      # a prefill into a fresh dense cache
        got[dev], _, _ = forward(cfg, base, torch.tensor([toks]).to(d),
                                 cache=init_cache(cfg, 1, FP32_PROMPT, d))
    err = (got["cuda"].cpu() - got["cpu"]).abs().max().item()
    torch.testing.assert_close(got["cuda"].cpu(), got["cpu"], atol=1e-3,
                               rtol=1e-3)
    log(f"[{tag}] base model's last logits over {FP32_PROMPT} tokens, card "
        f"vs CPU: max|err| {err:.3e} (tol 1e-3, logits std "
        f"{got['cpu'].std().item():.3f}) on {card}")


def moe_fp32(card, n_layers: int):
    """granite-moe-3b-a800m at full width, ``n_layers`` deep, fp32: the
    card's greedy tokens equal the CPU's, eager and chunked."""
    import gc

    import torch

    from repro_torch.launch.main_path import (CHUNKED, MOE_MODEL, NUM_PAGES,
                                              PAGE_SIZE)
    from repro_torch.serving import LocalDisaggEngine

    gc.collect()
    torch.cuda.empty_cache()
    both = card_and_cpu(MOE_MODEL, n_layers)
    fp32_logits(card, "moe fp32", both)
    for mode, kw in (("eager", {}), ("chunked", CHUNKED)):
        got = {}
        for dev, (cfg, base, decs) in both.items():
            eng = LocalDisaggEngine(cfg, base, decs, device=dev,
                                    num_pages=NUM_PAGES // 8,
                                    page_size=PAGE_SIZE, **kw)
            got[dev] = paged_small_turns(eng, cfg)
            del eng
        assert got["cuda"] == got["cpu"], (mode, got)
        n = sum(map(len, got["cuda"]))
        distinct = len(set(t for r in got["cuda"] for t in r))
        log(f"[moe fp32] {MOE_MODEL} {n_layers} layers fp32 {mode}: card "
            f"greedy tokens == CPU greedy tokens, all {n} ({distinct} "
            f"distinct, at least {FP32_MIN_DISTINCT} asserted) on {card}")
        assert distinct >= FP32_MIN_DISTINCT, (mode, got)
    del both


def phase_moe(card, n_layers: int | None):
    """granite-moe-3b-a800m (40 experts top-8, a query group of 3 at
    head_dim 64) on the paged main path at full width: phase 4's traffic
    eager, then phase 5's chunked over the same weights on a fresh pool,
    then ``moe_fp32``. Launch counters are zeroed just before each path and
    read just after; it returns the eager path's."""
    import gc

    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.main_path import (CHUNKED, MOE_MODEL,
                                              build_engine, rebuild_engine,
                                              resident_bytes)
    from repro_torch.params import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    t = time.perf_counter()
    cfg, eng = build_engine(n_layers, model=MOE_MODEL)
    torch.cuda.synchronize()
    full = get_config(MOE_MODEL)
    nparam = sum(x.numel() for x in tree_leaves(eng.base_params))
    log(f"[moe] {cfg.name}: {cfg.n_layers} of {full.n_layers} layers, "
        f"d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads} "
        f"(group {cfg.n_heads // cfg.n_kv_heads}) x {cfg.head_dim}, "
        f"{cfg.n_experts} experts top-{cfg.top_k} of d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}, {nparam} parameters a model; base + "
        f"2 decoders + 2048x16 pool ready in {time.perf_counter() - t:.2f} s")
    free0 = eng.block_pool.free_count
    probe = DropProbe(cfg.n_layers)  # every layer is MoE
    launches, reqs, turns, _, _ = serve_turns(eng, cfg, card, "moe")
    drops = probe.close()
    s = eng.stats()
    log(f"[moe] stats {json.dumps(s)}")
    assert s["prefill_tokens_reused"] > 0, s
    assert launches["paged_write"] > 0, launches
    assert launches["flash_prefill_paged"] == 0, launches   # eager prefill
    assert launches["paged_decode"] == cfg.n_layers * s["decode_dispatches"] \
        > 0, (launches, s)
    assert eng.block_pool.free_count == free0
    eng.block_pool.check_invariants()
    check_memory(eng, mem0, card, "moe")
    report_metrics(eng, card, "moe")
    log(f"[moe] prefill dropped_frac, mean over layers, by forward shape "
        f"(expert capacity from S): {drops}")
    e_tokens = [list(o.tokens) for o in reqs]
    del reqs
    old, eng = eng, rebuild_engine(eng, **CHUNKED)
    del old                                    # frees the eager pool
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated() - resident_bytes(eng)
    probe = DropProbe(cfg.n_layers)  # every layer is MoE
    c_launches, c_reqs, _, _, _ = serve_turns(eng, cfg, card, "moe chunked")
    drops = probe.close()
    s = eng.stats()
    assert c_launches["flash_prefill_paged"] > 0, c_launches
    assert c_launches["paged_write"] == 0, c_launches
    assert c_launches["paged_decode"] == \
        cfg.n_layers * s["decode_dispatches"] > 0, (c_launches, s)
    assert eng.block_pool.free_count == free0
    check_memory(eng, mem0, card, "moe chunked")
    report_metrics(eng, card, "moe chunked")
    log(f"[moe chunked] prefill dropped_frac by chunk forward shape: "
        f"{drops}")
    same = sum(a == b for c, e in zip(c_reqs, e_tokens)
               for a, b in zip(c.tokens, e))
    log(f"[moe chunked] greedy tokens equal to the eager run's: {same} of "
        f"{sum(map(len, e_tokens))} (not asserted: expert capacity depends "
        f"on each forward's S); distinct tokens "
        f"{len(set(t for r in e_tokens for t in r))}")
    del eng, c_reqs
    moe_fp32(card, min(FP32_LAYERS, n_layers or FP32_LAYERS))
    return launches


# ======================================================================
# phase 13: the dense fallback at full width


def dense_turns(eng, cfg, prompt_n, tail_n, gen, sampled=False):
    """The dense fallback's traffic on one session: a context of
    ``prompt_n`` tokens, then two turns, each appending a ``tail_n``-token
    tail and then the answer per model (the dense session cache is
    append-only), ``gen`` greedy tokens; then, if ``sampled``, one seeded
    sampled request on the session and one in a one-shot session. Launch
    counters are zeroed just before and read just after. Returns
    (tokens, launches, requests)."""
    import numpy as np
    import torch

    from repro_torch.launch.main_path import tokens
    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(2)
    ctx = tokens(cfg, rng, prompt_n)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    reqs = []
    for _ in range(2):
        for m in ("m0", "m1"):
            ctx = ctx + tokens(cfg, rng, tail_n)
            reqs.append(eng.generate(m, ctx, SamplingParams(max_tokens=gen),
                                     session=0))
            ctx = ctx + list(reqs[-1].tokens)
    if sampled:
        sp = SamplingParams(max_tokens=gen, seed=SAMPLED_SEEDS["m0"],
                            **SAMPLED)
        ctx = ctx + tokens(cfg, rng, tail_n)
        reqs.append(eng.generate("m1", ctx, sp, session=0))
        reqs.append(eng.generate("m0", ctx, sp))        # one-shot session
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    for r in reqs:
        assert r.finished and len(r.tokens) == gen, r
        assert all(0 <= t < cfg.vocab_size for t in r.tokens), r
    return [list(r.tokens) for r in reqs], launches, reqs


def dense_fp32(card, name, n_layers: int):
    """``name`` at full width, ``n_layers`` deep, fp32, on the dense
    fallback: the card's greedy tokens equal the CPU's."""
    import gc

    import torch

    from repro_torch.launch.main_path import DENSE_CAPACITY
    from repro_torch.serving import LocalDisaggEngine

    gc.collect()
    torch.cuda.empty_cache()
    got = {}
    both = card_and_cpu(name, n_layers)
    fp32_logits(card, f"dense fp32 {name}", both)
    for dev, (cfg, base, decs) in both.items():
        eng = LocalDisaggEngine(cfg, base, decs, device=dev,
                                capacity=DENSE_CAPACITY)
        got[dev], _, _ = dense_turns(eng, cfg, FP32_PROMPT, FP32_TAIL,
                                     FP32_GEN)
        del eng, base, decs
    del both
    assert got["cuda"] == got["cpu"], (name, got)
    distinct = len(set(t for r in got["cuda"] for t in r))
    log(f"[dense fp32] {name} {n_layers} layers fp32: card greedy tokens == "
        f"CPU greedy tokens, all {sum(map(len, got['cuda']))} ({distinct} "
        f"distinct, at least {FP32_MIN_DISTINCT} asserted) on {card}")
    assert distinct >= FP32_MIN_DISTINCT, (name, got)


#: phase 13's fp32 depth per arch: one whole layer group
DENSE_FP32_LAYERS = {"mamba2-780m": 2, "recurrentgemma-2b": 3,
                     "seamless-m4t-medium": 2, "gemma2-27b": 2}


def phase_dense(card, n_layers: int | None):
    """Each dense-fallback arch at full width (``main_path.DENSE_ARCHS``;
    gemma2-27b 4 layers deep), a base and two decoders: a shared
    1000-token context (shorter than every window) and two turns of one
    request per model, 32 greedy tokens each, then a seeded sampled request
    on the session and one in a one-shot session; then the same arch in
    fp32 at 2-3 layers, card against CPU. Each arch's weights are freed
    before the next."""
    import gc

    import torch

    from repro_torch.kvcache.handoff import transfer_cache
    from repro_torch.launch.main_path import (DENSE_ARCHS, DENSE_CAPACITY,
                                              PROMPT_TOKENS, TAIL_TOKENS,
                                              build_engine, resident_bytes)
    from repro_torch.params import tree_leaves
    from repro_torch.serving import SamplingParams

    for name, depth in DENSE_ARCHS.items():
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        if n_layers is not None:
            depth = min(depth or n_layers, n_layers)
        cfg, eng = build_engine(depth, model=name, capacity=DENSE_CAPACITY)
        torch.cuda.synchronize()
        # serving's peak: init's fp32 transients are freed by now
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        held = resident_bytes(eng)
        nparam = sum(x.numel() for x in tree_leaves(eng.base_params))
        assert not eng.paged and eng.decode_plane is None
        log(f"[dense] {name} ({cfg.arch_type}): {cfg.n_layers} layers "
            f"(pattern {cfg.layer_pattern}, encoder {cfg.encoder_layers}), "
            f"d_model {cfg.d_model}, vocab {cfg.vocab_size}, window "
            f"{cfg.sliding_window}, {cfg.dtype}, {nparam} parameters a "
            f"model; base + 2 decoders ({held} B) ready in "
            f"{time.perf_counter() - t:.2f} s")
        t0 = time.perf_counter()
        toks, launches, reqs = dense_turns(eng, cfg, PROMPT_TOKENS,
                                           TAIL_TOKENS, 32, sampled=True)
        wall = time.perf_counter() - t0
        s = eng.stats()
        assert s["prefill_tokens_reused"] > 0, s
        assert all(n == 0 for n in launches.values()), launches
        if name == "mamba2-780m":
            dense_invoke(card, eng, cfg)
        w = eng.prefill_workers[0]
        # the B=1 decode loop alone, timed over a copy of the session cache
        sc = w.sessions[0]
        t1 = time.perf_counter()
        loop, _ = eng.decoders["m0"].generate(
            transfer_cache(sc.cache), sc.n_tokens, 2,
            SamplingParams(max_tokens=32))
        torch.cuda.synchronize()
        per_tok = (time.perf_counter() - t1) / len(loop)
        assert w.mgr.pool.active_count > 0          # the session holds pages
        eng.end_session(0)
        assert w.mgr.pool.active_count == 0, w.mgr.pool.active_count
        assert not w.sessions
        peak = torch.cuda.max_memory_allocated()
        log(f"[dense] {name}: max_memory_allocated while serving {peak} B; "
            f"weights {held} B; allocated before {mem0} B on {card}")
        assert peak <= mem0 + PEAK_SLACK_BYTES, (peak, mem0)
        # a dense request is synchronous and streams its tokens when its
        # loop ends (as the reference's): TTFT is the whole request, and
        # the per-token decode wall is the loop's own
        ttft = [r.ttft for r in reqs]
        log(f"[dense] {name}: {len(reqs)} requests, "
            f"{sum(map(len, toks))} tokens in {wall:.3f} s; TTFT (the whole "
            f"synchronous request) {percentiles(ttft)}; B=1 decode loop "
            f"{per_tok * 1e3:.3f} ms a token; prefill tokens computed "
            f"{s['prefill_tokens_computed']}, reused "
            f"{s['prefill_tokens_reused']}; handoff bytes "
            f"{s['handoff_bytes']}; {len(set(t for r in toks for t in r))} "
            f"distinct tokens; session pages released on {card}")
        del eng, reqs, w, sc          # the worker's stats hold the engine
        dense_fp32(card, name, DENSE_FP32_LAYERS[name])


# ======================================================================
# phase 11: priority preemption at full width (run after phase 5)


#: the preemption fleet (phase 11; phase 6 serves it in fp32 at 4 layers):
#: PREEMPT_LO low-priority prompts of PREEMPT_LO_PROMPT tokens decoding
#: PREEMPT_LO_TOKENS, to "mb" and "m0" in turn; once all of them decode and
#: PREEMPT_LEAD more steps have run, PREEMPT_HI priority-5 prompts of
#: PREEMPT_HI_PROMPT tokens decoding PREEMPT_HI_TOKENS
PREEMPT_LO, PREEMPT_LO_PROMPT, PREEMPT_LO_TOKENS = 6, 200, 128
PREEMPT_HI, PREEMPT_HI_PROMPT, PREEMPT_HI_TOKENS = 2, 1000, 32
PREEMPT_LEAD = 32
#: pages of 16 tokens (2 MiB each at Llama-3.1-8B width in bf16): the
#: armed runs' pool, which the low-priority decodes fill so that the
#: high-priority prompts enter only by preempting them, and the unarmed
#: run's, which holds the whole fleet at once
PREEMPT_PAGES = 216
ROOMY_PAGES = 512
ARMED = dict(preempt=True, overcommit=2.0, sanitize=True)


def preempt_fleet(eng, cfg, seeded=False):
    """Serve the preemption fleet on ``eng``; returns the (low, high)
    priority request handles, all finished, the pool back at its free
    count."""
    import numpy as np

    from repro_torch.launch.main_path import tokens
    from repro_torch.serving import SamplingParams

    rng = np.random.default_rng(11)
    lo_prompts = [tokens(cfg, rng, PREEMPT_LO_PROMPT)
                  for _ in range(PREEMPT_LO)]
    hi_prompts = [tokens(cfg, rng, PREEMPT_HI_PROMPT)
                  for _ in range(PREEMPT_HI)]

    def sp(n, seed):
        return SamplingParams(max_tokens=n, **(
            dict(SAMPLED, seed=seed) if seeded else {}))
    free0 = eng.block_pool.free_count
    models = ("mb", "m0")
    lo = [eng.generate(models[i % 2], p, sp(PREEMPT_LO_TOKENS, 100 + i),
                       priority=0) for i, p in enumerate(lo_prompts)]
    while len(eng.scheduler.active) < PREEMPT_LO:
        eng.step()
    for _ in range(PREEMPT_LEAD):
        eng.step()
    hi = [eng.generate(models[i % 2], p, sp(PREEMPT_HI_TOKENS, 200 + i),
                       priority=5) for i, p in enumerate(hi_prompts)]
    eng.run()
    for h in lo + hi:
        assert h.finished and h.finish_reason == "length", h
    assert eng.block_pool.free_count == free0, (eng.block_pool.free_count,
                                                free0)
    eng.block_pool.check_invariants()
    return lo, hi


class SwapProbe:
    """Watches an armed engine's swap tier: every transfer's direction,
    bytes and seconds (what ``observe`` receives), that what ``put`` copied
    to the host equals the pool rows it read, and that each restore's rows,
    read back from the pool, equal what ``put`` read for them bit for bit
    (``moved``: of those, the pages restored into another row)."""

    def __init__(self, eng):
        import torch

        from repro_torch.kvcache.swap import _leaves

        host = eng.swap.host
        self.xfers = []                 # (direction, nbytes, seconds)
        self.checked = self.moved = 0
        way = ["out"]
        observe, put, restore = host.observe, host.put, host.restore

        def seen(nbytes, seconds):
            self.xfers.append((way[0], nbytes, seconds))
            observe(nbytes, seconds)

        def rows(kvpool, bids):
            idx = torch.tensor(list(bids), device=kvpool.device)
            return [a.index_select(axis, idx).cpu()
                    for _, _, a, axis in _leaves(kvpool.pool_state())]

        def probed_put(kvpool, rid, bids):
            way[0] = "out"
            n = put(kvpool, rid, bids)
            copied = [h for _, _, h, _ in _leaves(host._entries[rid]["host"])]
            for a, b in zip(rows(kvpool, bids), copied, strict=True):
                assert torch.equal(a, b), "put copied other bits"
            return n

        def probed_restore(kvpool, rid, positions, dst):
            way[0] = "in"
            entry = host._entries[rid]
            sel = torch.tensor(list(positions))
            want = [h.index_select(axis, sel)
                    for _, _, h, axis in _leaves(entry["host"])]
            n = restore(kvpool, rid, positions, dst)
            for a, b in zip(rows(kvpool, dst), want, strict=True):
                assert torch.equal(a, b), "restored rows differ from put's"
            self.checked += len(dst)
            self.moved += sum(d != entry["bids"][j]
                              for j, d in zip(positions, dst))
            return n

        host.observe = seen
        host.put, host.restore = probed_put, probed_restore

    def rate(self, way):
        """(bytes/s, transfers, mean seconds) of one direction."""
        xs = [(b, t) for w, b, t in self.xfers if w == way]
        if not xs:
            return None, 0, None
        nbytes, secs = sum(b for b, _ in xs), sum(t for _, t in xs)
        return nbytes / secs, len(xs), secs / len(xs)


def probe_rechunks(eng):
    """Time every chunk forward that re-prefills a dropped victim; returns
    the list it fills with ([(rid, start, take)], seconds, chunks in the
    call)."""
    import torch

    sched = eng.scheduler
    run = sched._run_chunks
    recs = []

    def timed(chunks):
        mine = [(r.rid, start, take) for r, start, take in chunks
                if r.resume_seq is not None]
        if not mine:
            return run(chunks)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = run(chunks)
        torch.cuda.synchronize()
        recs.append((mine, time.perf_counter() - t0, len(chunks)))
        return n
    sched._run_chunks = timed
    return recs


def percentiles(xs) -> str:
    import numpy as np
    if not xs:
        return "none"
    p50, p95 = np.percentile(np.asarray(xs, dtype=np.float64), [50, 95])
    return f"p50 {p50:.6f} s p95 {p95:.6f} s (n={len(xs)})"


def preempt_run(cfg, decs, device, name, seeded=False):
    """One serve of the preemption fleet on a fresh engine over ``decs``
    (``main_path.preempt_engine``, chunked): ``"off"`` unarmed over
    ``ROOMY_PAGES``, else armed (``ARMED``) over ``PREEMPT_PAGES`` in
    preemption mode ``name``. Launch counters are zeroed just before the
    fleet and read just after; peak memory must stay within what was
    allocated before (the weights) plus the pool plus 2 GiB."""
    import gc

    import torch

    from repro_torch.launch.main_path import CHUNKED, preempt_engine

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    armed = name != "off"
    eng = preempt_engine(cfg, decs, device,
                         PREEMPT_PAGES if armed else ROOMY_PAGES,
                         **CHUNKED, **(ARMED if armed else {}))
    probe = rechunks = None
    if armed:
        eng.swap.cfg.mode = name
        probe, rechunks = SwapProbe(eng), probe_rechunks(eng)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    lo, hi = preempt_fleet(eng, cfg, seeded)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in fns.items()}
    s = eng.stats()
    peak = torch.cuda.max_memory_allocated()
    pool = (eng.kvpool.num_pages + 1) * eng.kvpool.page_bytes
    assert peak <= mem0 + pool + PEAK_SLACK_BYTES, (peak, mem0, pool)
    assert launches["paged_decode"] == cfg.n_layers * s["decode_dispatches"] \
        > 0, (launches, s)
    assert launches["flash_prefill_paged"] > 0, launches
    assert launches["paged_write"] == 0, launches
    if armed:
        assert s["preemptions"] >= 1, s
        assert eng.sanitizer.checks == eng.scheduler.stats.steps, \
            (eng.sanitizer.checks, eng.scheduler.stats.steps)
        assert s["pages_swapped"] == s["swapped_seqs"] == 0, s
        assert len(eng.swap.host) == 0 and eng.swap.host.total_bytes == 0
    out = dict(tokens=[list(h.tokens) for h in lo + hi], stats=s,
               launches=launches, wall=wall, peak=peak, mem0=mem0,
               pool=pool, steps=eng.scheduler.stats.steps,
               hi_ttft=[h.ttft for h in hi],
               hi_itl=[x for h in hi for x in h.inter_token_latencies()],
               modes=list(eng.swap.modes) if armed else [],
               probe=probe, rechunks=rechunks,
               costmodel=eng.swap.costmodel if armed else None,
               pages=eng.block_pool.num_blocks,
               page_bytes=eng.kvpool.page_bytes)
    del eng, lo, hi
    return out


def phase_preempt(card, eager):
    """Priority preemption at full width and depth: Llama-3.1-8B, bf16,
    chunked (``main_path.CHUNKED``), over the stacked decoders of phases
    4-5 (``main_path.preempt_engine``: row 1 is the base and the
    relay-compatible model "mb", row 0 the swap-only "m0"). The fleet runs
    unarmed over a roomy pool, then armed over a pool the low-priority
    decodes fill, in forced swap, forced recompute and auto mode. Every
    armed run preempts, its sanitizer passes at every step, its pool comes
    back to baseline, its memory stays within its bound, and every swap
    restore reads back bit for bit what ``put`` read. Prints the host link
    measured each way, the seconds per swap, the cost model's re-prefill
    prediction beside the measured chunk time, auto mode's choices, the
    high-priority TTFT/ITL, and how many tokens agree with the unarmed run
    (not asserted: a batch of another row count rounds differently in
    bf16, and recompute re-prefills decode-written KV through S>1)."""
    cfg = eager["cfg"]
    decs = eager.pop("decoders")
    device = decs["m0"]["embed"].device
    log(f"[preempt] {cfg.name}: {cfg.n_layers} layers {cfg.dtype}; fleet: "
        f"{PREEMPT_LO} x {PREEMPT_LO_PROMPT}-token prompts decoding "
        f"{PREEMPT_LO_TOKENS} (priority 0, models mb/m0), then "
        f"{PREEMPT_HI} x {PREEMPT_HI_PROMPT}-token prompts decoding "
        f"{PREEMPT_HI_TOKENS} (priority 5); armed pool {PREEMPT_PAGES} "
        f"pages of 16 tokens, unarmed {ROOMY_PAGES}")
    runs = {}
    for name in ("off", "swap", "recompute", "auto"):
        r = runs[name] = preempt_run(cfg, decs, device, name)
        s = r["stats"]
        log(f"[preempt] {name}: {r['steps']} steps in {r['wall']:.3f} s; "
            f"preemptions {s['preemptions']} (modes {r['modes']}), "
            f"swap_out_pages {s['swap_out_pages']}, swap_in_pages "
            f"{s['swap_in_pages']}, swap_bytes {s['swap_bytes']}, "
            f"recompute_tokens {s['recompute_tokens']}; launches "
            f"{r['launches']}; peak {r['peak']} B within allocated before "
            f"{r['mem0']} B + pool {r['pool']} B ({r['pages']} pages of "
            f"{r['page_bytes']} B) + 2 GiB; sanitizer clean at every step; "
            f"free pages back to {r['pages']} on {card}")
        log(f"[preempt] {name}: high-priority TTFT "
            f"{percentiles(r['hi_ttft'])}; ITL {percentiles(r['hi_itl'])} "
            f"on {card}")
    assert runs["swap"]["modes"] and set(runs["swap"]["modes"]) == {"swap"}
    assert "recompute" in runs["recompute"]["modes"], runs["recompute"]
    probe = runs["swap"]["probe"]
    assert runs["swap"]["stats"]["swap_in_pages"] >= 1 and probe.checked, \
        "no swapped page was restored: the round trip went unchecked"
    log(f"[preempt] swap round trip: {probe.checked} restored pages read "
        f"back bit-equal to what put read ({probe.moved} of them into "
        f"another row)")
    for name in ("swap", "auto"):
        p = runs[name]["probe"]
        for way, label in (("out", "device -> pinned host"),
                           ("in", "pinned host -> device")):
            bw, n, mean = p.rate(way)
            if n:
                each = [f"{t:.6f}" for w, _, t in p.xfers if w == way]
                log(f"[preempt] {name}: {label}: {n} transfers, "
                    f"{bw:.4e} B/s, {mean:.6f} s per swap (each, in order: "
                    f"{each} s) on {card}")
    for name in ("recompute", "auto"):
        r = runs[name]
        by_rid = {}
        for mine, dt, n in r["rechunks"]:
            for rid, start, take in mine:
                rec = by_rid.setdefault(rid, dict(start=start, cold=0, s=0.0,
                                                  calls=0, shared=0))
                rec["cold"] += take
                rec["s"] += dt
                rec["calls"] += 1
                rec["shared"] += n > 1
        for rid, rec in sorted(by_rid.items()):
            want = r["costmodel"].recompute_s(rec["cold"],
                                              rec["start"] + rec["cold"])
            log(f"[preempt] {name}: victim rid {rid} re-prefilled "
                f"{rec['cold']} tokens past {rec['start']} cached: "
                f"CostModel predicts {want:.6f} s, measured {rec['s']:.6f} "
                f"s over {rec['calls']} chunk forward(s) ({rec['shared']} "
                f"shared with other requests' chunks) on {card}")
        if name == "recompute":
            assert by_rid, "no victim was re-prefilled"
    log(f"[preempt] auto mode chose {runs['auto']['modes']} (host link "
        f"estimate {runs['auto']['costmodel'].host_bw:.4e} B/s after "
        f"{runs['auto']['costmodel'].samples} transfers)")
    ref = runs["off"]["tokens"]
    total = sum(map(len, ref))
    for name in ("swap", "recompute", "auto"):
        same = sum(a == b for x, y in zip(runs[name]["tokens"], ref)
                   for a, b in zip(x, y))
        log(f"[preempt] {name}: greedy tokens equal to the unarmed run's: "
            f"{same} of {total} (not asserted in bf16)")
    relay_step(card, cfg, decs, device)


#: the relay chain's answers: the first request's, then the follow-up's
RELAY_GEN = (32, 16)


def relay_chain(eng, cfg):
    """tests/test_relay.py's chain at full width on the base itself
    (``"mb"``): a request over a fresh 1000-token prompt, then one whose
    prompt is that prompt, the first decode input and the answer, so its
    prefix lies in pages the first request's DECODE wrote. Returns both
    answers."""
    import numpy as np

    from repro_torch.launch.main_path import PROMPT_TOKENS, tokens
    from repro_torch.serving import SamplingParams
    prompt = tokens(cfg, np.random.default_rng(5), PROMPT_TOKENS)
    a = [int(t) for t in eng.generate(
        "mb", prompt, SamplingParams(max_tokens=RELAY_GEN[0])).result()]
    b = [int(t) for t in eng.generate(
        "mb", prompt + [2] + a,
        SamplingParams(max_tokens=RELAY_GEN[1])).result()]
    return a, b


def relay_step(card, cfg, decs, device):
    """Relay at full width and depth (bf16) over phase 11's pair, eager,
    ``ROOMY_PAGES``: with ``relay=True`` the first answer's decode-written
    pages are published and the follow-up's prefill is served from them
    (asserted: a publish and relay hit tokens); ``relay=False`` publishes
    nothing. Both pools return to baseline. How many follow-up tokens agree
    is printed, not asserted (bf16: the relayed KV was written by S=1
    decode steps, the cold one by an S>1 prefill)."""
    import gc

    import torch

    from repro_torch.launch.main_path import preempt_engine
    got = {}
    for relay in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        eng = preempt_engine(cfg, decs, device, ROOMY_PAGES, relay=relay)
        free0 = eng.block_pool.free_count
        t0 = time.perf_counter()
        got[relay] = relay_chain(eng, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        s = eng.stats()
        if relay:
            assert s["relay_publishes"] >= 1 and s["relay_hit_tokens"] > 0, s
        else:
            assert s["relay_publishes"] == 0 and s["relay_hit_tokens"] == 0, s
        assert eng.block_pool.active_count == 0, eng.block_pool.active_count
        eng.block_pool.check_invariants()
        log(f"[relay] relay={relay}: chain of {RELAY_GEN} tokens on model mb "
            f"in {wall:.3f} s; relay_publishes {s['relay_publishes']}, "
            f"relay_pages_published {s['relay_pages_published']}, "
            f"relay_hit_tokens {s['relay_hit_tokens']}, prefill tokens "
            f"reused {s['prefill_tokens_reused']} (free pages {free0} "
            f"before) on {card}")
        del eng
    same = sum(x == y for x, y in zip(got[True][1], got[False][1]))
    assert got[True][0] == got[False][0], got      # the same first request
    log(f"[relay] follow-up tokens equal with and without relay: {same} of "
        f"{RELAY_GEN[1]} (not asserted in bf16)")


# ======================================================================
# phase 18: the serving simulator, the serve launcher, and the cost model
# beside the measured steps (run after phase 9)


#: the simulator's cell: Llama-3.1-8B at its published widths, the react
#: agent pattern, the serve launcher's default session count and admission
#: cap, one H100 a worker, at a light and a heavy arrival rate (sessions/s)
SIM_SESSIONS, SIM_MAX_CONCURRENT, SIM_RATES = 80, 64, (2.0, 8.0)
#: the paper's headline ratios (Figs. 3-4): baseline p95 latency over
#: PrefillShare's, PrefillShare throughput over the baseline's
PAPER_P95_RATIO, PAPER_THROUGHPUT_RATIO = 4.5, 3.9
#: relayouts timed on phase 9's plane (each a register or an unregister)
RELAYOUT_PAIRS = 3
#: the serve launcher's local-engine run (the reference's toy fp32 config)
SERVE_ARGS = ["--engine", "local", "--turns", "1", "--gen", "4"]


def serve_output(device: str | None):
    """``python -m repro_torch.launch.serve`` with ``SERVE_ARGS`` (and
    ``--device``) in a process of its own; its output lines and wall."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *SERVE_ARGS]
    if device is not None:
        cmd += ["--device", device]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, (cmd, r.stderr[-4000:])
    return r.stdout.splitlines(), time.perf_counter() - t0


def profile_steps():
    """``python -m repro_torch.launch.profile --chunked`` in a process of
    its own (its profiler stays out of this one): the main path's chunked
    engine, whose JSON line gives the device time of a fused decode step
    of 4 rows and of a 1000-token context's five 200-token chunk
    forwards."""
    cmd = [sys.executable, "-m", "repro_torch.launch.profile", "--chunked"]
    env = dict(os.environ, PYTHONPATH=str(SRC))
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=900)
    assert r.returncode == 0, (cmd, r.stderr[-4000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def time_relayouts(eng, base, card) -> list:
    """Seconds of each decode-plane relayout on ``eng`` (phase 9's plane of
    four LoRA lanes): a fifth adapter registered and the plane rebuilt at
    the step boundary (``models.sync``), then unregistered and rebuilt,
    ``RELAYOUT_PAIRS`` times, each bracketed by ``synchronize``."""
    import torch

    from repro_torch.core.lora import lora_init
    from repro_torch.serving import DecodeModelSpec, LoRAAdapter
    g = torch.Generator(device=base["embed"].device).manual_seed(99)
    spec = DecodeModelSpec(lora=LoRAAdapter(
        lora_init(base, rank=LORA_RANK, generator=g), alpha=LORA_ALPHA,
        rank=LORA_RANK))
    times = []
    for _ in range(RELAYOUT_PAIRS):
        for change in (lambda: eng.models.register("l4", spec),
                       lambda: eng.models.unregister("l4")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            change()
            eng.models.sync()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
    assert eng.models.list() == sorted(LORA_MODELS), eng.models.list()
    (group,) = eng.decode_plane.groups
    assert group.lora and len(group.model_ids) == len(LORA_MODELS)
    log(f"[sim] decode-plane relayouts on phase 9's plane ({len(LORA_MODELS)}"
        f" LoRA lanes, a fifth registered then unregistered, "
        f"{RELAYOUT_PAIRS} times): s {[f'{t:.6f}' for t in times]} on "
        f"{card}")
    return times


def phase_sim(card, eager, lora):
    """Phase 18. The serve launcher's local engine on the card and on the
    CPU (the same greedy tokens, asserted); the serving simulator at
    Llama-3.1-8B width on the H100's figures, baseline and PrefillShare at
    ``SIM_RATES`` (every session completes; the ratios are printed beside
    the paper's); what the simulator's ``CostModel`` charges for the steps
    phases 4-5 timed, beside their wall times and the device times of
    ``launch.profile``; and a decode-plane relayout on phase 9's plane,
    the simulator's ``churn_rebuild_s``."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.launch.main_path import CHUNKED, MODEL, PROMPT_TOKENS
    from repro_torch.serving import (CostModel, ServingConfig, Simulator,
                                     make_sessions)
    from repro_torch.serving.costmodel import HBM_BYTES
    from repro_torch.serving.simulator import CHURN_REBUILD_S

    t_phase = time.perf_counter()
    times = time_relayouts(lora.pop("engine"), lora["base"], card)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"[sim] relayout median {np.median(times):.6f} s (ServingConfig."
        f"churn_rebuild_s is {CHURN_REBUILD_S}) on {card}")

    out = {}
    for dev in (None, "cpu"):
        out[dev], wall = serve_output(dev)
        log(f"[sim] python -m repro_torch.launch.serve {' '.join(SERVE_ARGS)}"
            f"{' --device ' + dev if dev else ''} ({wall:.1f} s): "
            f"{out[dev]}")
    assert out[None] == out["cpu"], out
    assert len(out[None]) == 4 and out[None][-1].startswith("hit_ratio=")
    log(f"[sim] serve launcher: card tokens == CPU tokens ({card})")

    cfg = get_config(MODEL)
    res = {}
    for rate in SIM_RATES:
        for mode in ("baseline", "prefillshare"):
            t0 = time.perf_counter()
            sim = Simulator(cfg, ServingConfig(
                mode=mode, chips_per_worker=1, hbm_per_worker=HBM_BYTES,
                max_concurrent=SIM_MAX_CONCURRENT), make_sessions(
                    "react", n_sessions=SIM_SESSIONS, arrival_rate=rate,
                    seed=0))
            r = res[(mode, rate)] = sim.run()
            assert r["sessions_done"] == SIM_SESSIONS, r
            assert np.isfinite(r["p95_e2e_s"]) and r["throughput_tok_s"] > 0
            log(f"[sim] {cfg.name} react, {SIM_SESSIONS} sessions at {rate}/s,"
                f" {mode}, one H100 (80 GB) a worker: p95 e2e "
                f"{r['p95_e2e_s']:.6f} s, p95 TTFT {r['p95_ttft_s']:.6f} s, "
                f"throughput {r['throughput_tok_s']:.3f} tok/s, prefix hit "
                f"{r['prefix_hit_ratio']:.4f}, evictions {r['evictions']}, "
                f"staged {r['staged_frac']:.4f} ({time.perf_counter() - t0:.2f}"
                f" s of host time)")
        b, p = res[("baseline", rate)], res[("prefillshare", rate)]
        log(f"[sim] rate {rate}/s: baseline/PrefillShare p95 e2e "
            f"{b['p95_e2e_s'] / p['p95_e2e_s']:.4f}x (paper "
            f"{PAPER_P95_RATIO}x), p95 TTFT "
            f"{b['p95_ttft_s'] / p['p95_ttft_s']:.4f}x; PrefillShare/"
            f"baseline throughput "
            f"{p['throughput_tok_s'] / b['throughput_tok_s']:.4f}x (paper "
            f"{PAPER_THROUGHPUT_RATIO}x); printed, not asserted")

    prof = profile_steps()
    cost = CostModel(cfg, chips=1)
    chunk = CHUNKED["chunk_size"]
    starts = range(0, PROMPT_TOKENS, chunk)
    model_ctx = sum(cost.prefill(min(chunk, PROMPT_TOKENS - st), st).seconds
                    for st in starts)
    ctx_dev = prof["context_prefill_device_ms"]
    log(f"[sim] {PROMPT_TOKENS}-token context in {len(starts)} chunk "
        f"forwards of {chunk}: CostModel {model_ctx:.6f} s; phase 5 wall "
        f"{eager['chunked_context_s']:.6f} s; device "
        f"{'not measured' if ctx_dev is None else f'{ctx_dev / 1e3:.6f} s'}"
        f" (launch.profile) on {card}")
    kv = PROMPT_TOKENS + 32 + 16       # mid-answer in turn 0
    fused = 2 * cost.decode_step(2, kv).seconds
    one = cost.decode_step(4, kv).seconds
    eager_step = [t["s"] / t["steps"] for t in eager["turns"]]
    step_dev = prof["decode_step_device_ms"]
    log(f"[sim] fused decode step, 2 decoders x 2 rows at ~{kv} tokens: "
        f"CostModel {fused:.6f} s (two decode_step(2); one model's "
        f"decode_step(4) {one:.6f} s); phase 4 wall per step "
        f"{[f'{x:.6f}' for x in eager_step]} s; launch.profile events "
        f"{np.median(prof['decode_step_ms']) / 1e3:.6f} s, device "
        f"{'not measured' if step_dev is None else f'{step_dev / 1e3:.6f} s'}"
        f" on {card}")
    log(f"[sim] phase 18 took {time.perf_counter() - t_phase:.1f} s")


# ======================================================================
# phases 14-17: training on the card (plain torch: no TPU kernel lies on
# the training path, so nothing here launches a Hopper kernel)

TRAIN_MODEL = "internlm2-1.8b"      # the reference launcher's default arch
TRAIN_STEPS = 10                     # pretrain steps, then Eq. 7 steps
TRAIN_BATCH = 48                     # the launcher's default
LONG_S = 4096                        # phase 15: one sequence this long
LORA_TRAIN_STEPS = 3                 # phase 16: Llama-3.1-8B LoRA steps
LORA_TRAIN_ROWS = 4                  # rows sharing phase 4's context
TRAIN_FP32_LAYERS = 2                # phase 17's depth
TRAIN_DEVICE = "cuda"                # phases 14-16's device (17: both)


class StepClock:
    """Wall seconds of every ``Trainer.step`` while installed (each step
    ends in a synchronise: ``fit`` reads the loss back)."""

    def __init__(self):
        from repro_torch.training.trainer import Trainer
        self.cls, self.orig, self.s = Trainer, Trainer.step, []

    def __enter__(self):
        import torch
        orig, s = self.orig, self.s

        def timed(tr, *a, **kw):
            t = time.perf_counter()
            out = orig(tr, *a, **kw)
            torch.cuda.synchronize()
            s.append(time.perf_counter() - t)
            return out
        self.cls.step = timed
        return self

    def __exit__(self, *exc):
        self.cls.step = self.orig


def steps_line(s) -> str:
    """Each step's wall in ms, and the mean past the first."""
    rest = s[1:] or s
    return (f"{[round(x * 1e3, 2) for x in s]} ms (mean past the first "
            f"{1e3 * sum(rest) / len(rest):.2f} ms)")


def same_tree(a, b) -> bool:
    import torch

    from repro_torch.params import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def phase_train(card):
    """Phase 14: ``launch/train.py``'s path on internlm2-1.8b at full width
    and depth (24 layers, d_model 2048, vocab 92544, bf16, seeded random
    weights): ``TRAIN_STEPS`` pretraining steps of the base, the
    checkpoint, ``TRAIN_STEPS`` Eq. 7 steps of a decoder initialised as the
    base (full weights, fp32 AdamW moments), the decoder's checkpoint and
    ``evaluate`` on the shared cache. Each step's wall, peak memory and the
    losses; the losses finite, the base bit-unchanged by fine-tuning (read
    back from the checkpoint written before it), the decoder changed, and
    both checkpoints read back bit-equal. Returns the base for phase 15."""
    import gc
    import math
    import shutil

    import torch

    from repro_torch.launch import train as launch
    from repro_torch.params import tree_leaves
    from repro_torch.training import data as D
    from repro_torch.training.checkpoint import load

    gc.collect()
    torch.cuda.empty_cache()
    out = ROOT / "build" / "train_ckpt"
    args = launch.parser().parse_args([
        "--arch", TRAIN_MODEL, "--pretrain-steps", str(TRAIN_STEPS),
        "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
        "--out", str(out / "ckpt"), "--device", TRAIN_DEVICE])
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepClock() as clock:
        res = launch.run(args)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cfg, base, dec = res["cfg"], res["base"], res["dec"]
    nparam = sum(x.numel() for x in tree_leaves(base))
    pre_s, ft_s = clock.s[:TRAIN_STEPS], clock.s[TRAIN_STEPS:]
    # the rows' lengths: pretraining's first batch (the task mixture), and
    # the fine-tuning domain's (every batch alike)
    b = next(D.batches(0, D.TaskSpec("mix", prompt_len=10, n_symbols=8),
                       TRAIN_BATCH, 1))
    pre_n = b.prompt.shape[1] + b.target_in.shape[1]
    b = next(D.batches(0, D.TaskSpec(args.domain, prompt_len=10,
                                     n_symbols=8), TRAIN_BATCH, 1))
    sp, st = b.prompt.shape[1], b.target_in.shape[1]
    rest_pre, rest_ft = pre_s[1:] or pre_s, ft_s[1:] or ft_s
    log(f"[train] {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}, {nparam} "
        f"parameters; the launcher's path (batch {TRAIN_BATCH}, prompt 10 "
        f"symbols of 8) in {wall:.2f} s on {card}")
    log(f"[train] pretrain steps ({TRAIN_BATCH} x {pre_n} tokens at the "
        f"first) {steps_line(pre_s)}, "
        f"{TRAIN_BATCH * pre_n * len(rest_pre) / sum(rest_pre):.1f} "
        f"tokens/s; losses {[round(x, 4) for x in res['pretrain_losses']]}")
    log(f"[train] cache-conditioned (Eq. 7) steps ({TRAIN_BATCH} x {sp} "
        f"prompt tokens through the frozen base, {TRAIN_BATCH} x {st} "
        f"target tokens trained) {steps_line(ft_s)}, "
        f"{TRAIN_BATCH * st * len(rest_ft) / sum(rest_ft):.1f} target "
        f"tokens/s; losses {[round(x, 4) for x in res['losses']]}")
    log(f"[train] shared-cache accuracy (per token, share ratio 1) "
        f"{res['acc']:.4f}; max_memory_allocated {peak} B (allocated "
        f"before {mem0} B; one model's weights {2 * nparam} B) on {card}")
    losses = res["pretrain_losses"] + res["losses"]
    assert all(math.isfinite(x) for x in losses), losses
    assert not same_tree(dec, base), "fine-tuning left the decoder as the base"
    t1 = time.perf_counter()
    for tree, path in ((base, res["base_path"]), (dec, res["dec_path"])):
        back = load(path, tree)
        assert same_tree(back, tree), path
        del back
    size = sum(p.stat().st_size for p in out.glob("*.npz"))
    log(f"[train] both checkpoints ({size} B of .npz) read back bit-equal in "
        f"{time.perf_counter() - t1:.2f} s; the base read back from its "
        f"checkpoint (written before fine-tuning) equals the base after it")
    shutil.rmtree(out)
    del dec, res
    return cfg, base


def phase_train_long(card, cfg, base):
    """Phase 15: one ``train_loss`` step of internlm2-1.8b at S=4096, B=1,
    ``remat=True``: Sq * Tk = 16.8M is past the reference's 8.4M switch,
    so every layer's attention runs ``_FlashAttention`` (its forward twice,
    the remat recomputing it, its backward once: counted). Loss and
    backward, then an AdamW update, each timed (two steps, the first
    warming up); peak memory."""
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.models import attention as attn_mod
    from repro_torch.models.model import train_loss
    from repro_torch.params import tree_leaves, tree_map
    from repro_torch.training.optim import AdamW, apply_updates

    gc.collect()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(5)
    toks, tgt = (torch.tensor(rng.integers(4, cfg.vocab_size, (1, LONG_S)),
                              dtype=torch.int32, device=TRAIN_DEVICE)
                 for _ in range(2))
    mask = torch.ones((1, LONG_S), dtype=torch.float32, device=TRAIN_DEVICE)
    calls = {"fwd": 0, "bwd": 0}
    orig = attn_mod._flash, attn_mod._flash_bwd

    def fwd(*a):
        calls["fwd"] += 1
        return orig[0](*a)

    def bwd(*a):
        calls["bwd"] += 1
        return orig[1](*a)

    opt = AdamW(1e-4, weight_decay=0.01)
    state = opt.init(base)
    params = base
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    attn_mod._flash, attn_mod._flash_bwd = fwd, bwd
    try:
        times = []
        for _ in range(2):
            calls.update(fwd=0, bwd=0)
            p = tree_map(lambda x: x.detach().requires_grad_(True), params)
            t0 = time.perf_counter()
            loss, _ = train_loss(cfg, p, toks, tgt, mask, remat=True)
            loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            grads = tree_map(lambda x: x.grad, p)
            p = tree_map(torch.Tensor.detach, p)
            upd, state = opt.update(grads, state, p)
            params = apply_updates(p, upd)
            del grads, upd, p
            torch.cuda.synchronize()
            times.append((t1 - t0, time.perf_counter() - t1, loss.item()))
    finally:
        attn_mod._flash, attn_mod._flash_bwd = orig
    peak = torch.cuda.max_memory_allocated()
    assert calls == {"fwd": 2 * cfg.n_layers, "bwd": cfg.n_layers}, calls
    assert all(math.isfinite(t[2]) for t in times), times
    assert all(torch.isfinite(x).all() for x in tree_leaves(params))
    log(f"[train S={LONG_S}] {cfg.name} B=1 remat: _FlashAttention forward "
        f"{calls['fwd']}x, backward {calls['bwd']}x a step; loss + backward "
        f"{[round(t[0] * 1e3, 2) for t in times]} ms, AdamW update "
        f"{[round(t[1] * 1e3, 2) for t in times]} ms, losses "
        f"{[round(t[2], 4) for t in times]} "
        f"({LONG_S / times[-1][0]:.1f} tokens/s through loss + backward); "
        f"max_memory_allocated {peak} B (allocated before {mem0} B) on "
        f"{card}")


def int_sum(tree) -> list:
    """An exact checksum per leaf (its bits summed as integers)."""
    import torch

    from repro_torch.params import tree_leaves
    views = {2: torch.int16, 4: torch.int32}
    return [int(x.view(views[x.element_size()]).sum(dtype=torch.int64))
            for x in tree_leaves(tree)]


def phase_train_lora(card, lora):
    """Phase 16: Llama-3.1-8B at full width and depth (phase 9's base, bf16)
    fine-tuned through ``cache_conditioned_lora_loss`` (rank 16, alpha 32,
    wq/wv/wo; A random, B zero as ``lora_init`` makes them) for
    ``LORA_TRAIN_STEPS`` AdamW steps over phase 4's shared 1000-token
    context, ``LORA_TRAIN_ROWS`` rows of 32-token targets. Each step's
    wall, peak memory against the base plus the merged targets; the base
    bit-unchanged, the adapters changed."""
    import gc
    import math

    import numpy as np
    import torch

    from repro_torch.core.lora import cache_conditioned_lora_loss, lora_init
    from repro_torch.launch.main_path import PROMPT_TOKENS, tokens
    from repro_torch.models.model import _layers
    from repro_torch.params import tree_leaves
    from repro_torch.training.optim import AdamW
    from repro_torch.training.trainer import Trainer

    cfg, base = lora["cfg"], lora["base"]
    gc.collect()
    torch.cuda.empty_cache()
    ads = lora_init(base, rank=LORA_RANK,
                    generator=torch.Generator(TRAIN_DEVICE).manual_seed(11))
    prompt = tokens(cfg, np.random.default_rng(0), PROMPT_TOKENS)  # phase 4's
    rng = np.random.default_rng(6)
    R = LORA_TRAIN_ROWS
    feed = [{"prompt": np.array([prompt] * R, np.int32),
             "target_in": rng.integers(4, cfg.vocab_size, (R, 32)),
             "target_out": rng.integers(4, cfg.vocab_size, (R, 32)),
             "target_mask": np.ones((R, 32), np.float32)}
            for _ in range(LORA_TRAIN_STEPS)]
    before = int_sum(base)
    lp, _ = next(_layers(cfg, base, None))
    merged = cfg.n_layers * sum(lp["attn"][k].nbytes
                                for k in ("wq", "wv", "wo"))
    base_bytes = sum(x.nbytes for x in tree_leaves(base))
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tr = Trainer(lambda p, **kw: cache_conditioned_lora_loss(
        cfg, p, base, alpha=LORA_ALPHA, rank=LORA_RANK, **kw), AdamW(1e-3))
    with StepClock() as clock:
        trained, losses = tr.fit(ads, feed)
    peak = torch.cuda.max_memory_allocated()
    n_ad = sum(x.numel() for x in tree_leaves(ads))
    log(f"[train lora] {cfg.name} {cfg.n_layers} layers {cfg.dtype}, rank "
        f"{LORA_RANK} alpha {LORA_ALPHA} on wq/wv/wo ({n_ad} adapter "
        f"parameters), {R} rows x ({PROMPT_TOKENS} shared + 32 target) "
        f"tokens: steps {steps_line(clock.s)}; losses "
        f"{[round(x, 6) for x in losses]}")
    log(f"[train lora] max_memory_allocated {peak} B: {peak - mem0} B above "
        f"what was allocated before ({mem0} B, phase 9's base {base_bytes} B "
        f"among it); the merged wq/wv/wo of every layer {merged} B on {card}")
    assert all(math.isfinite(x) for x in losses), losses
    assert int_sum(base) == before, "the frozen base changed"
    assert not same_tree(trained, ads), "the adapters did not change"


def phase_train_fp32(card):
    """Phase 17: internlm2-1.8b at full width in fp32, depth cut to
    ``TRAIN_FP32_LAYERS``, card against CPU: the Eq. 7 loss at share ratio
    0.5 (layer 0 from the base's cache, layer 1 from the decoder's own,
    in the graph) within 1e-5; every gradient leaf within 1e-4 of its
    largest CPU element (fp32 sums in another order; TF32 is off); one
    AdamW update from the same (CPU) gradients within 1e-6. Then
    ``_FlashAttention`` at the model's heads (16 over 8, head_dim 128),
    1024 tokens in 256 x 512 blocks, window and softcap: o, dq, dk, dv
    within 1e-4 of each one's largest CPU element."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.prefillshare import cache_conditioned_loss
    from repro_torch.models import init_params
    from repro_torch.models.attention import attention
    from repro_torch.params import tree_leaves, tree_map
    from repro_torch.training import data as D
    from repro_torch.training.optim import AdamW, apply_updates

    gc.collect()
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config(TRAIN_MODEL),
                              n_layers=TRAIN_FP32_LAYERS, dtype="float32")
    trees = {"cuda": [init_params(cfg, s, TRAIN_DEVICE) for s in (0, 1)]}
    trees["cpu"] = [tree_map(lambda x: x.cpu(), t) for t in trees["cuda"]]
    b = next(D.batches(2, D.TaskSpec("copy", prompt_len=10, n_symbols=8,
                                     vocab=cfg.vocab_size), 4, 1))
    res = {}
    for dev, (base, dec) in trees.items():
        p = tree_map(lambda x: x.detach().requires_grad_(True), dec)
        loss, _ = cache_conditioned_loss(
            cfg, p, base, *(torch.tensor(a).to(dec["embed"].device) for a in
                            (b.prompt, b.target_in, b.target_out,
                             b.target_mask)), share_ratio=0.5)
        loss.backward()
        res[dev] = (loss.item(), tree_map(lambda x: x.grad.cpu(), p))
    lerr = abs(res["cuda"][0] - res["cpu"][0])
    assert lerr <= 1e-5 * max(1.0, abs(res["cpu"][0])), res
    rel = [float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
           for g, w in zip(tree_leaves(res["cuda"][1]),
                           tree_leaves(res["cpu"][1]))]
    assert max(rel) <= 1e-4, rel
    stepped = {}
    for dev, (_, dec) in trees.items():
        g = tree_map(lambda w, x: w.to(x.device), res["cpu"][1], dec)
        opt = AdamW(1e-3, weight_decay=0.01)
        upd, _ = opt.update(g, opt.init(dec), dec)
        stepped[dev] = [x.cpu() for x in tree_leaves(apply_updates(dec, upd))]
    uerr = max(float((a - c).abs().max())
               for a, c in zip(stepped["cuda"], stepped["cpu"]))
    assert uerr <= 1e-6, uerr
    log(f"[train fp32] {cfg.name} at full width, {cfg.n_layers} layers, "
        f"fp32, Eq. 7 at share ratio 0.5, card vs CPU: loss "
        f"{res['cpu'][0]:.6f} (|err| {lerr:.3e}, tol 1e-5); "
        f"{len(rel)} gradient leaves, max|err| / max|grad| per leaf at most "
        f"{max(rel):.3e} (tol 1e-4); one AdamW update from the same "
        f"gradients max|err| {uerr:.3e} (tol 1e-6) on {card}")
    del trees, stepped, res

    rng = np.random.default_rng(8)
    S, Hq, Hkv, D_ = 1024, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = rng.standard_normal((1, S, Hq, D_), np.float32)
    k, v = (rng.standard_normal((1, S, Hkv, D_), np.float32)
            for _ in range(2))
    do = rng.standard_normal((1, S, Hq, D_), np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    out = {}
    for dev in ("cpu", "cuda"):
        d = TRAIN_DEVICE if dev == "cuda" else dev
        ts = [torch.tensor(a, device=d, requires_grad=True)
              for a in (q, k, v)]
        o = attention(*ts, torch.tensor(pos, device=d),
                      torch.tensor(pos, device=d), window=300,
                      softcap=30.0, force_flash=True, q_chunk=256,
                      kv_chunk=512)
        o.backward(torch.tensor(do, device=d))
        out[dev] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    rel = [float((a - c).abs().max() / c.abs().max())
           for a, c in zip(out["cuda"], out["cpu"])]
    assert max(rel) <= 1e-4, rel
    log(f"[train fp32] _FlashAttention at {cfg.name}'s heads ({Hq} over "
        f"{Hkv}, head_dim {D_}), {S} tokens, window 300, softcap 30, card "
        f"vs CPU: o, dq, dk, dv max|err| / max {[f'{r:.2e}' for r in rel]} "
        f"(tol 1e-4) on {card}")
    gc.collect()


# ======================================================================
# phase 19: the step builders at full width (launch/steps.py), each step's
# single-device dry run (launch/dryrun.py) against the card

#: phase 19's input shapes, registered as ``InputShape``s (name: kind,
#: seq_len, batch): decode against a 32768-token cache, a 32768-token
#: prefill, a train step of 4 x 4096 tokens (bf16 AdamW moments)
STEP_SHAPES = {"step_decode": ("decode", 32768, 4),
               "step_prefill": ("prefill", 32768, 1),
               "step_train": ("train", 4096, 4)}
STEP_TRACES = ROOT / "build" / "step_traces.json"
MEM_REL = 0.02                     # allocation growth and peak, relative


def register_step_shapes():
    from repro_torch.configs.base import INPUT_SHAPES, InputShape
    for name, (kind, seq, batch) in STEP_SHAPES.items():
        INPUT_SHAPES[name] = InputShape(name, seq, batch, kind)


def write_step_traces(path) -> None:
    """The single-device dry run of each ``STEP_SHAPES`` step of
    ``TRAIN_MODEL`` on fake tensors (host only, no card), as JSON."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun
    register_step_shapes()
    cfg = get_config(TRAIN_MODEL)
    out = {name: dryrun.trace(cfg, name) for name in STEP_SHAPES}
    Path(path).write_text(json.dumps(out))


def start_step_traces():
    """``write_step_traces`` in a process of its own, started after phase
    2's kernel timings: tracing the 32768-token prefill on fake tensors
    takes minutes of host time (every chunk of the flash loop is
    dispatched), which then runs beside the card's phases. The process
    sees no card, runs at the lowest priority and is pinned to the last
    core, and this process to the others, so that the launch-bound timings
    of the later phases do not share a core with it."""
    STEP_TRACES.unlink(missing_ok=True)
    STEP_TRACES.parent.mkdir(parents=True, exist_ok=True)
    code = (f"import os, sys; os.nice(19); "
            f"sys.path[:0] = [{str(ROOT)!r}, {str(SRC)!r}]; "
            f"import chip_smoke; "
            f"chip_smoke.write_step_traces({str(STEP_TRACES)!r})")
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env)
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) > 1:
        os.sched_setaffinity(proc.pid, cores[-1:])
        os.sched_setaffinity(0, cores[:-1])
    return proc


def phase_steps(card, cfg, base, tracer):
    """Phase 19: ``launch.steps.build(cfg, shape)`` at full width for
    internlm2-1.8b (phase 14's weights), per ``STEP_SHAPES``: the
    arguments materialized on the card (``steps.materialize``, the base
    reused as the params) hold exactly the dry run's single-device
    ``argument_size_in_bytes`` (a consistency check: both sides are
    ``steps._arguments``), and ``memory_allocated`` grows by them (less the
    reused base) within ``MEM_REL``; each step twice, timed by CUDA events,
    with finite outputs; the peak allocation above the start is the new
    arguments plus the dry run's predicted temporaries within ``MEM_REL``
    (the dry run's one prediction independent of the card); the serve
    step's greedy tokens equal ``forward``'s on the same cache (a
    consistency check: the serve step is ``forward``); the dry run's flops
    (torch's FlopCounter formulas) over the device time, beside 989
    TFLOP/s. The train step rewrites the base in place, so it runs last and
    the base is dropped after."""
    import gc
    import math

    import torch

    from repro_torch.launch import steps
    from repro_torch.models.model import forward
    from repro_torch.params import tree_leaves

    t_phase = time.perf_counter()
    rc = tracer.wait(timeout=900)
    assert rc == 0, f"the dry-run process exited {rc}"
    traces = json.loads(STEP_TRACES.read_text())
    log(f"[steps] waited {time.perf_counter() - t_phase:.1f} s for the "
        f"dry-run process")
    register_step_shapes()
    base_bytes = steps.arg_bytes(base)
    for name, (kind, seq, batch) in STEP_SHAPES.items():
        pred = traces[name]
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        b = steps.build(cfg, name)
        args = steps.materialize(cfg, name, TRAIN_DEVICE, params=base,
                                 seed=19)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - mem0
        nbytes = steps.arg_bytes(args)
        assert nbytes == pred["memory"]["argument_size_in_bytes"], (
            name, nbytes, pred["memory"])
        assert abs(grown - (nbytes - base_bytes)) <= MEM_REL * (
            nbytes - base_bytes), (name, grown, nbytes - base_bytes)
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(2):
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            out = b["fn"](*args)
            t1.record()
            t1.synchronize()
            ms.append(t0.elapsed_time(t1))
        peak = torch.cuda.max_memory_allocated() - mem0
        want_peak = nbytes - base_bytes + pred["memory"]["temp_size_in_bytes"]
        assert abs(peak - want_peak) <= MEM_REL * want_peak, (
            name, peak, want_peak)
        if kind == "train":
            loss = out[2].item()
            assert math.isfinite(loss), loss
            assert all(torch.isfinite(x).all() for x in tree_leaves(out[0]))
            got = f"loss {loss:.4f}"
        else:
            logits = out[0]
            assert torch.isfinite(logits).all(), name
            got = f"logits {tuple(logits.shape)}"
            if kind == "decode":
                with torch.no_grad():
                    want, _, _ = forward(cfg, base, args[1], cache=args[2],
                                         pos=args[3])
                assert torch.equal(logits.argmax(-1), want.argmax(-1)), name
                got += (f", greedy tokens {logits.argmax(-1).tolist()} "
                        f"== forward's")
        flops = pred["cost"]["flops"]
        best = min(ms)
        log(f"[steps] {name} ({kind}, B={batch}, S={seq}): {got}; device "
            f"ms by events {[round(x, 3) for x in ms]}; dry-run flops "
            f"{flops:.6g} -> {flops / best / 1e9:.2f} TFLOP/s, "
            f"{flops / best / 1e9 / (BF16_FLOPS / 1e12):.4f} of "
            f"{BF16_FLOPS / 1e12:.0f}; arguments {nbytes} B (dry run "
            f"{pred['memory']['argument_size_in_bytes']} B; allocation grew "
            f"{grown} B for {nbytes - base_bytes} B new), bytes bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms; temp predicted "
            f"{pred['memory']['temp_size_in_bytes']} B, max_memory_allocated "
            f"{peak} B above the arguments' start (new arguments + temp "
            f"{want_peak} B, {(peak - want_peak) / want_peak:+.4%}); dry run "
            f"traced in {pred['lower_s']} s on {card}")
        del args, out, b
    log(f"[steps] phase 19 took {time.perf_counter() - t_phase:.1f} s")


# ======================================================================
# Queue 3 item 3: a bf16 row against the fused step's batch width

BF16_WIDTHS = (1, 2, 4, 8)


def phase_bf16_width(card, eager):
    """One fixed row (model 0's token 1234 at position 15 of a page of its
    own) through phase 4's fused decode step (``decode_stacked`` over the
    two stacked decoders) at batch widths ``BF16_WIDTHS``, the other rows
    padding: its bf16 logits' max |delta| against width 1 and whether the
    argmax agrees, printed. Nothing is asserted (bf16)."""
    import torch

    from repro_torch.models.model import decode_stacked

    eng, cfg = eager["engine"], eager["cfg"]
    grp = eng.decode_plane.groups[0]
    M, dev = len(grp.model_ids), eng.kvpool.device
    page = eng.block_pool.alloc(1)
    try:
        k_layers, v_layers = eng.kvpool.layers()
        rows = torch.zeros(1, dtype=torch.int64, device=dev)
        out = {}
        with torch.no_grad():
            for w in BF16_WIDTHS:
                toks = torch.zeros((M, w), dtype=torch.int32, device=dev)
                pos = torch.zeros((M, w), dtype=torch.int32, device=dev)
                bt = torch.zeros((M * w, 1), dtype=torch.int32, device=dev)
                toks[0, 0], pos[0, 0], bt[0, 0] = 1234, 15, page[0]
                out[w] = decode_stacked(cfg, grp.stacked, toks, pos,
                                        k_layers, v_layers, bt, rows=rows,
                                        lanes=grp._lanes)[0, 0].clone()
    finally:
        eng.block_pool.drop(page)
    ref = out[BF16_WIDTHS[0]]
    for w in BF16_WIDTHS:
        d = (out[w] - ref).abs()
        log(f"[bf16 width] width {w} ({M} x {w} rows): max |delta| against "
            f"width 1 {d.max().item():.6g}, {int((d == 0).sum())} of "
            f"{d.numel()} logits equal, argmax {out[w].argmax().item()} "
            f"(width 1: {ref.argmax().item()}, "
            f"{'agrees' if out[w].argmax() == ref.argmax() else 'differs'})"
            f" on {card}")


# ======================================================================
# phase 20: the request-id surface (submit / invoke / result / pop_result)


#: phase 20's caller-managed sessions, one per decode model, and the greedy
#: tokens of each request
REQUEST_ID_SIDS = {"m0": 101, "m1": 102}
REQUEST_ID_GEN = 32


def deprecated(fn, *args, **kw):
    """``fn(*args, **kw)``, asserting that it warned as deprecated."""
    import warnings
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        out = fn(*args, **kw)
    assert any(issubclass(w.category, DeprecationWarning)
               and "is deprecated" in str(w.message) for w in seen), seen
    return out


def phase_request_ids(card, eager):
    """Phase 20 (after phase 4, on its engine): ``submit`` of one request
    per decode model over phase 4's shared context plus a 32-token tail,
    each on a session of its own, then ``run``; then ``generate`` of the
    same prompts on the same sessions (the sibling path: the same pages, so
    both decode over bit-identical context K/V in batches of the same
    shape) and ``run``. The tokens must be equal; ``result`` keeps the
    entry, ``pop_result`` releases it, a second pop raises."""
    import numpy as np
    import torch

    from repro_torch.launch.main_path import PROMPT_TOKENS, TAIL_TOKENS, tokens
    from repro_torch.serving import SamplingParams

    eng, cfg = eager["engine"], eager["cfg"]
    # phase 4's shared context (cached in the prefix tree), new tails
    prompt = tokens(cfg, np.random.default_rng(0), PROMPT_TOKENS)
    rng = np.random.default_rng(20)
    prompts = {m: prompt + tokens(cfg, rng, TAIL_TOKENS)
               for m in REQUEST_ID_SIDS}
    free0 = eng.block_pool.free_count
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    disp0 = eng.stats.decode_dispatches
    t0 = time.perf_counter()
    rids = {m: deprecated(eng.submit, sid, prompts[m], m,
                          gen_tokens=REQUEST_ID_GEN)
            for m, sid in REQUEST_ID_SIDS.items()}
    eng.run()
    torch.cuda.synchronize()
    t_submit = time.perf_counter() - t0
    outs = {m: eng.generate(m, prompts[m],
                            SamplingParams(max_tokens=REQUEST_ID_GEN),
                            session=sid)
            for m, sid in REQUEST_ID_SIDS.items()}
    eng.run()
    torch.cuda.synchronize()
    launches = {n: fn.launches for n, fn in fns.items()}
    dispatches = eng.stats.decode_dispatches - disp0
    for m, rid in rids.items():
        got = eng.result(rid)
        assert got is eng.result(rid)                 # not consumed
        want = np.asarray(outs[m].result(), np.int32)
        assert len(got) == REQUEST_ID_GEN, (m, got)
        assert np.array_equal(got, want), (m, got, want)
        assert np.array_equal(eng.pop_result(rid), want)
        assert rid not in eng._results
        try:
            eng.pop_result(rid)
        except KeyError as e:
            assert "already fetched" in str(e), e
        else:
            raise AssertionError(f"a second pop_result({rid}) returned")
    for sid in REQUEST_ID_SIDS.values():
        eng.end_session(sid)
    assert eng.block_pool.free_count == free0, (eng.block_pool.free_count,
                                                free0)
    eng.block_pool.check_invariants()
    assert launches["paged_write"] > 0, launches
    assert launches["paged_decode"] == cfg.n_layers * dispatches, (
        launches, dispatches)
    assert launches["flash_prefill_paged"] == 0, launches   # eager prefill
    log(f"[request ids] submit/run/result over the shared context: "
        f"{len(rids)} requests x {REQUEST_ID_GEN} tokens in {t_submit:.3f} s, "
        f"tokens == generate(...).result() on the same sessions; "
        f"pop_result released each entry, a second pop raised; launches "
        f"{launches} over {dispatches} decode dispatches on {card}")


def dense_invoke(card, eng, cfg):
    """Phase 20 on phase 13's mamba2-780m engine: ``invoke`` over a fresh
    1000-token context on a caller-managed session, then
    ``generate(...).result()`` of the same context in a one-shot session:
    the same tokens (both prefill it from scratch)."""
    import numpy as np
    import torch

    from repro_torch.launch.main_path import PROMPT_TOKENS, tokens
    from repro_torch.serving import SamplingParams

    ctx = tokens(cfg, np.random.default_rng(21), PROMPT_TOKENS)
    fns = counters()
    for fn in fns.values():
        fn.launches = 0
    t0 = time.perf_counter()
    got = deprecated(eng.invoke, 1, ctx, "m0", gen_tokens=REQUEST_ID_GEN)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = eng.generate("m0", ctx, SamplingParams(
        max_tokens=REQUEST_ID_GEN)).result()
    launches = {n: fn.launches for n, fn in fns.items()}
    eng.end_session(1)
    assert len(got) == REQUEST_ID_GEN, got
    assert np.array_equal(got, np.asarray(want, np.int32)), (got, want)
    assert all(n == 0 for n in launches.values()), launches
    log(f"[request ids] {cfg.name} dense fallback: invoke == "
        f"generate(...).result(), {len(got)} tokens ({len(set(got.tolist()))} "
        f"distinct), invoke {dt:.3f} s; launches {launches} (the dense "
        f"fallback runs no kernel) on {card}")


# ======================================================================


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_layers = int(sys.argv[1]) if len(sys.argv) > 1 else None
    t_start = time.perf_counter()
    tracers = []
    try:
        return run_phases(torch, n_layers, t_start, tracers)
    finally:
        for tracer in tracers:
            if tracer.poll() is None:
                tracer.kill()
                tracer.wait()


def run_phases(torch, n_layers, t_start, tracers) -> int:
    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    phase_build()
    perf = phase_kernels(card)
    tracers.append(start_step_traces())
    phase_toy_engine()
    eager_launches, eager = phase_main_path(card, n_layers)
    phase_bf16_width(card, eager)
    phase_request_ids(card, eager)
    api_launches = phase_kernel_api(card, eager)
    phase_sampled(card, eager)
    chunked_launches = phase_chunked(card, eager)
    phase_preempt(card, eager)
    lora = phase_lora(card, eager)
    phase_sim(card, eager, lora)
    del eager
    phase_fp32_parity(card, min(FP32_LAYERS, n_layers or FP32_LAYERS))
    phase_lora_identity(card, min(FP32_LAYERS, n_layers or FP32_LAYERS))
    phase_moe(card, n_layers)
    phase_dense(card, n_layers)
    t = time.perf_counter()
    train_cfg, train_base = phase_train(card)
    phase_train_long(card, train_cfg, train_base)
    phase_steps(card, train_cfg, train_base, tracers[0])
    del train_base
    phase_train_lora(card, lora)
    phase_train_fp32(card)
    log(f"[train] phases 14-17 took {time.perf_counter() - t:.1f} s")
    phase_device_times(card, lora)

    # each kernel with its launches on the path that runs it: the eager
    # main path (phase 4) for paged_decode and paged_write, the kernel API
    # (after phase 4) for flash_prefill, the chunked main path (phase 5)
    # for flash_prefill_paged
    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill.py:88",
                                 api_launches),
               "paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                                "src/repro/kernels/paged_decode.py:72",
                                eager_launches),
               "paged_write": ("src/repro_torch/csrc/paged_write.cu",
                               "src/repro/kernels/paged_write.py:43",
                               eager_launches),
               "flash_prefill_paged": (
                   "src/repro_torch/csrc/flash_prefill_paged.cu",
                   "src/repro/kernels/flash_prefill_paged.py:86",
                   chunked_launches)}
    kernels = [dict(name=n, route="cuda", source=src, replaces=rep,
                    launches=runs[n], **perf[n])
               for n, (src, rep, runs) in sources.items()]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on its path")
    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
