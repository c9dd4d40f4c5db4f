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
     and chunk shapes for both paged kernels in fp32 (2e-5) and bf16, and
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
     ragged fused batch;
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
     Then phase 9;
  6. the same two paths at full width in fp32, depth cut to 4 layers, same
     traffic: greedy tokens identical and context K/V within
     ``FP32_KV_REL`` per layer. Then phase 10;
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
     step's wall time (the merge's device time in phase 7);
  10. (after phase 6) four LoRA decode models at full width, depth cut to
     4 layers, fp32 and bf16: tokens of the fused LoRA group == the
     all-full plane of the materialized trees, and in fp32 also == the
     per-model path (lazily materialized ``lora_apply``); in bf16 the
     per-model path's agreement is printed, not asserted.
The last two lines are the card's nvidia-smi name/power line and
``{"ok": true, "device": {...}}``. It needs the repository's ``src/``
beside it and a CUDA card; without either it prints no result and exits 1.
"""
from __future__ import annotations

import json
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
# chatglm3-6b's heads (src/repro/configs/chatglm3_6b.py: 32 query heads over
# 2 kv heads, a query group of 16, head_dim 128), page 16: paged-eligible in
# the reference, and taken by both paged kernels
CHATGLM = dict(Hq=32, Hkv=2, D=128, page=16)
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


def decode_shape_inputs(name, g):
    """q, k/v pools, block tables and lengths of DECODE_SHAPES[name] on the
    card, bf16; random values from the CUDA generator ``g``, lengths (and
    the engine layout's pages) from numpy seed 0."""
    import numpy as np
    import torch
    B, npages, (lo, hi), engine = DECODE_SHAPES[name]
    Hq, Hkv, D, page, P = 32, 8, 128, 16, 2049
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ln = rng.integers(lo, hi, B)
    q = torch.randn((B, Hq, D), generator=g, device=dev).bfloat16()
    kp = torch.randn((P, page, Hkv, D), generator=g, device=dev).bfloat16()
    vp = torch.randn((P, page, Hkv, D), generator=g, device=dev).bfloat16()
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
    from repro_torch.kernels.paged_write import (launch_on_device_tables,
                                                 paged_write)
    from repro_torch.kernels.ref import (MAIN_SHAPE_BF16_TOL,
                                         ref_paged_decode, ref_paged_write)

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
    c = CHATGLM
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
    # engine's own B=4 step (DECODE_SHAPES)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    dec = {}
    for name in DECODE_SHAPES:
        q, kp, vp, bt, ln = decode_shape_inputs(name, g)
        B, Hq, D = q.shape
        page, Hkv = kp.shape[1], kp.shape[2]
        npages = bt.shape[1]
        splits = choose_splits(B, Hkv, npages * page, sms)
        got = paged_decode_attention(q, kp, vp, bt, ln)
        want = ref_paged_decode(q, kp, vp, bt, ln)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        torch.testing.assert_close(got.float(), want.float(),
                                   **MAIN_SHAPE_BF16_TOL)
        capped = paged_decode_attention(q, kp, vp, bt, ln, softcap=30.0)
        want_c = ref_paged_decode(q, kp, vp, bt, ln, softcap=30.0)
        torch.cuda.synchronize()
        torch.testing.assert_close(capped.float(), want_c.float(),
                                   **MAIN_SHAPE_BF16_TOL)
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
        nbytes = (L * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                  + live_pages * 4 + B * 4)
        bound = max(nbytes / HBM_BYTES_PER_S,
                    4 * Hq * D * L / BF16_FLOPS) * 1e3
        log(f"[paged_decode] {name} shape B={B} Hq={Hq} Hkv={Hkv} D={D} "
            f"page={page} npages={npages} bf16 lengths {ln.tolist()}, "
            f"{splits} key part(s) on {sms} SMs: max|err| {err:.3e}, "
            f"relative norm {rel:.3e}, softcap 30 max|err| {err_c:.3e} "
            f"(tol {MAIN_SHAPE_BF16_TOL}); kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, sdpa on pre-gathered dense "
            f"K/V (gather excluded) {lib:.4f} ms, bound {bound:.4f} ms "
            f"({nbytes} B) on {card}")
        dec[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                         bound_ms=bound, bound_by="bytes", library_ms=lib)
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

    n_full, prompt, npg = 32, 1024, 64
    Hkv, D, page, P1 = 8, 128, 16, 2049           # Llama-3.1-8B's pool
    nk = torch.randn((n_full, prompt, Hkv, D), generator=g,
                     device=dev).to(torch.bfloat16)
    nv = torch.randn((n_full, prompt, Hkv, D), generator=g,
                     device=dev).to(torch.bfloat16)
    kpool = torch.randn((n_full * P1, page, Hkv, D), generator=g,
                        device=dev).to(torch.bfloat16)
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
    rows = int(valid.numel()) * page * Hkv * D * 2      # bf16 bytes, one tensor
    wr_bytes = 2 * 2 * rows + tbl.size * 4 + nvl.size * 4
    wr_bound = wr_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[paged_write] Llama fold: {n_full} layers x {prompt}-token prompt "
        f"({npg - 4}/{npg} pages valid) bf16: bitwise equal, pages past "
        f"n_valid untouched; kernel {wr_ms:.4f} ms (tables on the card), "
        f"wrapper with host check and uploads {wr_wrapper:.4f} ms, plain "
        f"{wr_plain:.4f} ms,"
        f" index_copy_ (k and v) {wr_lib:.4f} ms, bound {wr_bound:.4f} ms "
        f"({wr_bytes} B) on {card}")
    del nk, nv, kpool, vpool, src_k, src_v
    torch.cuda.empty_cache()
    return {
        "flash_prefill": phase_flash_kernel(card),
        "flash_prefill_paged": phase_prefill_kernel(card),
        "paged_decode": dec["main"],
        "paged_write": dict(max_abs_err=wr_err, ms=wr_ms, plain_ms=wr_plain,
                            bound_ms=wr_bound, bound_by="bytes",
                            library_ms=wr_lib),
    }


def prefill_bound_ms(start, S, Hq, Hkv, D, page, npages, itemsize) -> tuple:
    """(bound ms, "bytes" or "operations", bytes, flops) of one
    flash_prefill_paged call: each visible K/V row, q and the output moved
    once; 4 * Hq * D flops per visible (query, key) pair."""
    T = npages * page
    B = len(start)
    kv_rows = sum(min(st + S, T) for st in start)
    pairs = sum(min(st + i + 1, T) for st in start for i in range(S))
    nbytes = (kv_rows * Hkv * D * 2 * itemsize + 2 * B * S * Hq * D * itemsize
              + B * npages * 4 + B * 4)
    flops = 4 * Hq * D * pairs
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
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
    c = CHATGLM
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

    # the chunked main path's shapes (MAIN_CHUNKS)
    Hq, Hkv, D, page, P = 32, 8, 128, 16, 2049
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    perf = None
    for B, S, st0 in MAIN_CHUNKS:
        start = [st0] * B
        bt = chunk_table(B, S, st0, page, P, 4)
        npages = bt.shape[1]
        splits = choose_splits(B, S, Hq, Hkv, npages * page, sms)
        q, kp, vp, btd, std = inputs(B, Hq, Hkv, D, page, npages, P, S,
                                     torch.bfloat16, start, bt)
        got = flash_prefill_paged(q, kp, vp, btd, std)
        want = ref_paged_prefill(q, kp, vp, btd, std)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        rel = ((got.float() - want.float()).norm()
               / want.float().norm()).item()
        torch.testing.assert_close(got.float(), want.float(),
                                   **MAIN_SHAPE_PREFILL_BF16_TOL)
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
                                                    page, npages, 2)
        log(f"[flash_prefill_paged] main shape B={B} S={S} start "
            f"{start[0]} Hq={Hq} Hkv={Hkv} D={D} page={page} npages="
            f"{npages} bf16, {splits} key part(s) on {sms} SMs: max|err| "
            f"{err:.3e}, relative norm {rel:.3e} "
            f"(tol {MAIN_SHAPE_PREFILL_BF16_TOL}); kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, sdpa on pre-gathered dense K/V (gather "
            f"excluded) {lib_ms:.4f} ms, bound {bound:.4f} ms by {by} "
            f"({nbytes} B, {flops} flop; {flops / ms / 1e9:.2f} TFLOP/s, "
            f"{bound / ms:.3f} of the bound) on {card}")
        if start[0] == 800:             # the heaviest context chunk
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
# name, B, Hq, Hkv, S, T, D, dtype, window, softcap, query scale: the full
# widths the kernel API runs at. Llama-3.1-8B (configs/llama31_8b.py) at the
# main path's 1000-token shared context and at 8192; Gemma-2-27B
# (src/repro/configs/gemma2_27b.py) at 8192 with its 4096-token window and
# softcap 50, its queries scaled by 8 (scores of std ~8) so that the cap
# bends the largest scores (tests/test_torch_kernels.py::FLASH_TOL_SHAPES
# shows that skipping it then fails the tolerance); Llama at 1000 in fp32.
FLASH_MAIN = [
    ("a", 1, 32, 8, 1000, 1000, 128, "bfloat16", 0, 0.0, 1.0),
    ("b", 1, 32, 8, 8192, 8192, 128, "bfloat16", 0, 0.0, 1.0),
    ("c", 1, 32, 16, 8192, 8192, 128, "bfloat16", 4096, 50.0, 8.0),
    ("d", 1, 32, 8, 1000, 1000, 128, "float32", 0, 0.0, 1.0),
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
    for name, B, Hq, Hkv, S, T, D, dt, window, cap, qs in FLASH_MAIN:
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


# ======================================================================
# phase 7


def phase_device_times(card, lora):
    """Device time (``device_ms``) of the tensor-core kernels at the main
    shapes: ``paged_decode`` at both DECODE_SHAPES and ``flash_prefill_paged``
    at every MAIN_CHUNKS forward, each beside SDPA on pre-gathered dense
    K/V, dense ``flash_prefill`` at FLASH_MAIN's bf16 shapes. Then the
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

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    for name in DECODE_SHAPES:
        q, kp, vp, bt, ln = decode_shape_inputs(name, g)
        ms = device_ms(lambda: paged_decode_attention(q, kp, vp, bt, ln))
        kd, vd, mask, qg = decode_sdpa_inputs(q, kp, vp, bt, ln)
        lib = device_ms(lambda: F.scaled_dot_product_attention(
            qg, kd, vd, attn_mask=mask))
        log(f"[device time] paged_decode {name} shape B={q.shape[0]} "
            f"npages={bt.shape[1]} bf16: kernel (with its merge) "
            f"{fmt_ms(ms)}, sdpa on pre-gathered dense K/V {fmt_ms(lib)} "
            f"(torch.profiler, mean of 20 calls) on {card}")
        del q, kp, vp, kd, vd
    Hq, Hkv, D, page, P = 32, 8, 128, 16, 2049
    G = Hq // Hkv
    for B, S, st0 in MAIN_CHUNKS:
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
        log(f"[device time] flash_prefill_paged B={B} S={S} start {st0} "
            f"bf16: kernel {fmt_ms(ms)}, sdpa on pre-gathered dense K/V "
            f"{fmt_ms(lib)} (torch.profiler, mean of 20 calls) on {card}")
        del q, kp, vp, kd, vd, qd, mask
    for name, B, Hq, Hkv, S, T, D, dt, window, cap, qs in FLASH_MAIN:
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
    # the base and the adapters stay for phase 7's device time of a merge
    return dict(cfg=cfg, base=base, ab=group.stacked["ab"])


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

    card = card_line()
    log(f"[device] {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)}")
    phase_build()
    perf = phase_kernels(card)
    phase_toy_engine()
    eager_launches, eager = phase_main_path(card, n_layers)
    api_launches = phase_kernel_api(card, eager)
    phase_sampled(card, eager)
    chunked_launches = phase_chunked(card, eager)
    lora = phase_lora(card, eager)
    del eager
    phase_fp32_parity(card, min(FP32_LAYERS, n_layers or FP32_LAYERS))
    phase_lora_identity(card, min(FP32_LAYERS, n_layers or FP32_LAYERS))
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
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
