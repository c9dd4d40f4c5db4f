#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [n_layers]     # default: all 32 layers

Phases, in order; any failure exits non-zero (nothing is caught):
  1. device and build: the card's name and power limit; both CUDA sources
     built with nvcc for sm_90a, with ptxas' register/shared-memory/spill
     report;
  2. each Hopper kernel against its plain PyTorch version: the reference's
     kernel-test cases plus the main path's shapes (bf16 decode there held
     to ``kernels.ref.MAIN_SHAPE_BF16_TOL``), with CUDA-event times of the
     kernel alone, the plain version and a library yardstick, and the bound;
  3. a toy fp32 engine on the card against the same engine on the CPU:
     identical greedy tokens;
  4. the main path at full width (``repro_torch.launch.main_path``):
     LocalDisaggEngine serving Llama-3.1-8B (32 layers, bf16, seeded random
     weights) with a base model and two full-weight decode models over a
     2048-page pool: a shared ~1000-token context, two requests per model,
     then a second turn that hits the prefix cache; launch counters are
     zeroed just before and read just after, and peak device memory must
     stay within the weights, held once, plus the pool and 2 GiB.
The last two lines are the card's nvidia-smi name/power line and
``{"ok": true, "device": {...}}``. It needs the repository's ``src/``
beside it and a CUDA card; without either it prints no result and exits 1.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
BF16_FLOPS = 989e12                # H100 SXM dense bf16 tensor-core peak
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


# ======================================================================
# phase 1


def phase_build():
    from repro_torch.kernels import _build
    t = time.perf_counter()
    reports = _build.build_all(force=True)
    log(f"[build] {sorted(reports)} in {time.perf_counter() - t:.3f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, out in sorted(reports.items()):
        for line in out.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"[ptxas {name}] {line.strip()}")


# ======================================================================
# phase 2


PAGED_CASES = [
    # B, Hq, Hkv, D, page, npages, pool  (tests/test_kernels.py)
    (3, 8, 2, 64, 16, 8, 40),
    (1, 4, 4, 128, 32, 4, 16),
    (2, 8, 1, 64, 16, 16, 64),
    (4, 2, 2, 32, 8, 4, 20),
]


def phase_kernels(card):
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.paged_decode import paged_decode_attention
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

    # --- paged_decode at the main path's shape
    B, Hq, Hkv, D, page, P = 8, 32, 8, 128, 16, 2049
    lengths = torch.tensor(np.random.default_rng(0).integers(1024, 4097, B),
                           dtype=torch.int32, device=dev)
    npages = 256                                   # 4096 / 16
    q, kp, vp, bt, ln = decode_inputs(B, Hq, Hkv, D, page, npages, P,
                                      torch.bfloat16, lengths)
    got = paged_decode_attention(q, kp, vp, bt, ln)
    want = ref_paged_decode(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    dec_err = (got.float() - want.float()).abs().max().item()
    dec_rel = ((got.float() - want.float()).norm() / want.float().norm()).item()
    torch.testing.assert_close(got.float(), want.float(), **MAIN_SHAPE_BF16_TOL)
    dec_ms = cuda_ms(lambda: paged_decode_attention(q, kp, vp, bt, ln))
    dec_plain = cuda_ms(lambda: ref_paged_decode(q, kp, vp, bt, ln))
    T = npages * page
    # yardstick: K/V gathered into dense (B, Hkv, T, D) beforehand (the
    # gather is not timed); the G query heads of one kv head are SDPA's
    # query rows, which is single-token GQA exactly
    kd = kp[bt.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3).contiguous()
    vd = vp[bt.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3).contiguous()
    mask = (torch.arange(T, device=dev)[None] < ln[:, None])[:, None, None]
    qg = q.view(B, Hkv, Hq // Hkv, D)
    lib_out = F.scaled_dot_product_attention(qg, kd, vd, attn_mask=mask)
    torch.testing.assert_close(lib_out.reshape(B, Hq, D).float(),   # sanity
                               want.float(), atol=2e-2, rtol=2e-2)
    dec_lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qg, kd, vd, attn_mask=mask))
    L = int(ln.sum())
    live_pages = int(((ln + page - 1) // page).sum())
    dec_bytes = (L * Hkv * D * 2 * 2 + 2 * q.numel() * 2
                 + live_pages * 4 + B * 4)
    dec_ops = 4 * Hq * D * L
    dec_bound = max(dec_bytes / HBM_BYTES_PER_S,
                    dec_ops / BF16_FLOPS) * 1e3
    log(f"[paged_decode] main shape B={B} Hq={Hq} Hkv={Hkv} D={D} page={page}"
        f" bf16 lengths {ln.tolist()}: max|err| {dec_err:.3e}, relative "
        f"norm {dec_rel:.3e} (tol {MAIN_SHAPE_BF16_TOL}); kernel "
        f"{dec_ms:.4f} ms, plain {dec_plain:.4f} ms, "
        f"sdpa on pre-gathered dense K/V (gather excluded) {dec_lib:.4f} ms,"
        f" bound {dec_bound:.4f} ms ({dec_bytes} B) on {card}")
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
    P1 = 2049
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
        "paged_decode": dict(max_abs_err=dec_err, ms=dec_ms,
                             plain_ms=dec_plain, bound_ms=dec_bound,
                             bound_by="bytes", library_ms=dec_lib),
        "paged_write": dict(max_abs_err=wr_err, ms=wr_ms, plain_ms=wr_plain,
                            bound_ms=wr_bound, bound_by="bytes",
                            library_ms=wr_lib),
    }


# ======================================================================
# phase 3


def phase_toy_engine():
    import numpy as np

    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import init_params
    from repro_torch.params import tree_map
    from repro_torch.serving import LocalDisaggEngine, SamplingParams

    # tests/test_paged_engine.py's fp32 toy config, with head_dim 32 (the
    # kernel is built for head_dim 32, 64 and 128; the toy's own is 16)
    cfg = ModelConfig(name="paged-eng", arch_type="dense", n_layers=2,
                      d_model=32, n_heads=2, n_kv_heads=1, head_dim=32,
                      d_ff=64, vocab_size=64, dtype="float32")
    cpu = {m: init_params(cfg, s, device="cpu")
           for m, s in (("base", 0), ("m0", 10), ("m1", 11))}
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {m: tree_map(lambda t: t.to(dev), t) for m, t in cpu.items()}
        eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"],
                                                 "m1": p["m1"]},
                                device=dev, num_pages=64, page_size=8)
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
        outs[dev] = got
    assert outs["cuda"] == outs["cpu"], outs
    log(f"[toy engine] card tokens == CPU tokens: {outs['cuda']}")


# ======================================================================
# phase 4


def phase_main_path(card, n_layers: int):
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels.paged_decode import paged_decode_attention
    from repro_torch.kernels.paged_write import paged_write
    from repro_torch.launch.main_path import (MODEL, PROMPT_TOKENS,
                                              TAIL_TOKENS, build_engine,
                                              resident_bytes, tokens)
    from repro_torch.serving import SamplingParams

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

    rng = np.random.default_rng(0)
    prompt = tokens(cfg, rng, PROMPT_TOKENS)
    tails = [tokens(cfg, rng, TAIL_TOKENS) for _ in range(8)]
    free0 = eng.block_pool.free_count
    params = SamplingParams(max_tokens=32)

    paged_decode_attention.launches = 0
    paged_write.launches = 0
    t_start = time.perf_counter()
    reqs = []
    with eng.shared_context(prompt) as ctx:
        for turn in range(2):
            outs = [ctx.generate(m, tails[4 * turn + 2 * i + j], params)
                    for i, m in enumerate(("m0", "m1")) for j in range(2)]
            t0 = time.perf_counter()
            steps0 = eng.stats.decode_steps
            eng.run()
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ntok = sum(len(o.tokens) for o in outs)
            log(f"[main] turn {turn}: {len(outs)} requests, {ntok} tokens in "
                f"{eng.stats.decode_steps - steps0} decode steps, "
                f"{dt:.3f} s -> {ntok / dt:.1f} decode tok/s; TTFT s "
                f"{[round(o.ttft, 4) for o in outs]} on {card}")
            reqs += outs
            ctx.extend(outs[0].tokens)         # next turn: a longer context
    wall = time.perf_counter() - t_start
    launches = {"paged_decode": paged_decode_attention.launches,
                "paged_write": paged_write.launches}

    s = eng.stats()
    log(f"[main] stats {json.dumps(s)}")
    for o in reqs:
        assert o.finished and len(o.tokens) == 32, o
        assert all(0 <= t < cfg.vocab_size for t in o.tokens), o
    assert s["prefill_tokens_reused"] > 0, s
    assert s["cow_page_copies"] > 0, s
    assert launches["paged_decode"] == cfg.n_layers * s["decode_dispatches"], \
        (launches, s)
    assert s["decode_dispatches"] == s["decode_steps"], s
    assert launches["paged_write"] > 0, launches
    assert eng.block_pool.free_count == free0, (eng.block_pool.free_count,
                                                free0)
    eng.block_pool.check_invariants()
    # the weights are held once: base + 2 decoders + pool, plus activations
    peak = torch.cuda.max_memory_allocated()
    held = resident_bytes(eng)
    log(f"[main] launches {launches}; wall {wall:.3f} s; "
        f"max_memory_allocated {peak} B ({peak / 2**30:.2f} GiB); weights + "
        f"pool {held} B ({held / 2**30:.2f} GiB) on {card}")
    assert peak <= mem0 + held + PEAK_SLACK_BYTES, (peak, mem0, held)
    return launches


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
    launches = phase_main_path(card, n_layers)

    sources = {"paged_decode": ("src/repro_torch/csrc/paged_decode.cu",
                                "src/repro/kernels/paged_decode.py:72"),
               "paged_write": ("src/repro_torch/csrc/paged_write.cu",
                               "src/repro/kernels/paged_write.py:43")}
    kernels = [dict(name=n, route="cuda", source=sources[n][0],
                    replaces=sources[n][1], launches=launches[n], **perf[n])
               for n in ("paged_decode", "paged_write")]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
