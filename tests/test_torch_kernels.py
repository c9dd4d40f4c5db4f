"""The port's kernel plain versions against the reference's kernels.

Inputs come from a numpy seed and reach both packages as numpy arrays. The
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them; the port's wrappers, given CPU tensors, run their plain PyTorch
versions (the Hopper kernels are held against those on the card by
tests/test_torch_gpu.py and chip_smoke.py). Tolerances are the reference's
own: 2e-5 in fp32, 2e-2 in bf16 (the two sides round bf16 at different
places); paged_write is a copy and must be bit-exact. The main-shape bf16
tolerances the card holds the kernels to are shown here to pass a result
rounded another way and to fail the faults they must catch. Dense
flash_prefill follows the Pallas kernel where its oracle differs: a row with
no visible key is 0 there, mean(v) in ``repro.kernels.ref``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill import flash_prefill as pallas_flash_prefill
from repro.kernels.flash_prefill_paged import \
    flash_prefill_paged as pallas_prefill_paged
from repro.kernels.ops import paged_attention
from repro.kernels.paged_write import paged_write as ref_pallas_paged_write
from repro.kernels.ref import ref_flash_prefill as jax_ref_flash_prefill
from repro.kernels.ref import ref_paged_decode as jax_ref_paged_decode
from repro.kernels.ref import ref_paged_prefill as jax_ref_paged_prefill
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels import _build
from repro_torch.kernels.flash_prefill_paged import (KEY_TILE, MAX_SPLITS,
                                                     ROW_TILE, choose_splits,
                                                     flash_prefill_paged)
from repro_torch.kernels.ops import flash_attention
from repro_torch.kernels import paged_decode as decode_mod
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kernels.paged_write import paged_write
from repro_torch.kernels.ref import (MAIN_SHAPE_BF16_TOL,
                                     MAIN_SHAPE_FLASH_BF16_TOL,
                                     MAIN_SHAPE_PREFILL_BF16_TOL,
                                     ref_flash_prefill, ref_merge_splits,
                                     ref_paged_decode, ref_paged_prefill)

# B, Hq, Hkv, D, page, npages, pool  (tests/test_kernels.py PAGED_CASES)
PAGED_CASES = [
    (3, 8, 2, 64, 16, 8, 40),
    (1, 4, 4, 128, 32, 4, 16),
    (2, 8, 1, 64, 16, 16, 64),
    (4, 2, 2, 32, 8, 4, 20),
    (2, 32, 2, 128, 16, 8, 20),      # chatglm3-6b's heads: group 16
    (2, 16, 1, 256, 16, 4, 12),      # group 16 at head_dim 256
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _decode_inputs(case, seed=0):
    B, Hq, Hkv, D, page, npages, P = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    bt = rng.integers(0, P, (B, npages)).astype(np.int32)
    ln = rng.integers(1, page * npages + 1, (B,)).astype(np.int32)
    return q, kp, vp, bt, ln


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["nocap", "softcap30"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_decode_plain_matches_reference(case, dtype, softcap):
    jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, bt, ln = _decode_inputs(case)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(bt), jnp.asarray(ln))
    pallas = paged_attention(*jargs, softcap=softcap, interpret=True)
    oracle = jax_ref_paged_decode(*jargs, softcap=softcap)
    targs = (torch.tensor(q).to(tdt), torch.tensor(kp).to(tdt),
             torch.tensor(vp).to(tdt), torch.tensor(bt), torch.tensor(ln))
    before = paged_decode_attention.launches
    got = paged_decode_attention(*targs, softcap=softcap)
    assert paged_decode_attention.launches == before   # CPU: plain version
    np.testing.assert_array_equal(
        got.float().numpy(), ref_paged_decode(*targs, softcap=softcap)
        .float().numpy())
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


# B, Hq, Hkv, D, page, npages, pool, S  (tests/test_kernels.py)
PAGED_PREFILL_CASES = [
    (2, 4, 2, 64, 8, 4, 16, 5),      # chunk boundary mid-page
    (1, 8, 1, 32, 16, 3, 8, 16),     # MQA, chunk == page
    (3, 2, 2, 64, 8, 6, 32, 7),      # MHA, ragged starts
    (1, 4, 2, 128, 16, 2, 8, 1),     # degenerate single-token chunk
    (1, 32, 2, 128, 16, 4, 12, 20),  # chatglm3-6b's heads: group 16
    (2, 16, 1, 256, 16, 3, 10, 9),   # group 16 at head_dim 256
]


def _prefill_inputs(case, seed=0):
    B, Hq, Hkv, D, page, npages, P, S = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    kp = rng.standard_normal((P, page, Hkv, D), np.float32)
    vp = rng.standard_normal((P, page, Hkv, D), np.float32)
    bt = rng.integers(0, P, (B, npages)).astype(np.int32)
    st = rng.integers(0, npages * page - S + 1, (B,)).astype(np.int32)
    return q, kp, vp, bt, st


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["nocap", "softcap30"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", PAGED_PREFILL_CASES, ids=str)
def test_paged_prefill_plain_matches_reference(case, dtype, softcap):
    """The wrapper on CPU tensors (the plain version) against the
    reference's plain version and its Pallas kernel in interpret mode, at
    chunk starts anywhere in a page."""
    jdt, tdt, tol = DTYPES[dtype]
    q, kp, vp, bt, st = _prefill_inputs(case)
    jargs = (jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
             jnp.asarray(bt), jnp.asarray(st))
    pallas = pallas_prefill_paged(*jargs, softcap=softcap, interpret=True)
    oracle = jax_ref_paged_prefill(*jargs, softcap=softcap)
    targs = (torch.tensor(q).to(tdt), torch.tensor(kp).to(tdt),
             torch.tensor(vp).to(tdt), torch.tensor(bt), torch.tensor(st))
    before = flash_prefill_paged.launches
    got = flash_prefill_paged(*targs, softcap=softcap)
    assert flash_prefill_paged.launches == before   # CPU: plain version
    assert got.dtype == tdt and got.shape == targs[0].shape
    np.testing.assert_array_equal(
        got.float().numpy(), ref_paged_prefill(*targs, softcap=softcap)
        .float().numpy())
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_paged_prefill_plain_matches_contiguous_flash():
    """Position logic end to end against the reference's DENSE flash
    oracle (tests/test_kernels.py): contiguous KV laid into identity-mapped
    pages, the chunk = the last S positions of a causal sequence, so the
    result is rows T-S.. of the dense one. head_dim 8 has no kernel: the
    plain version only."""
    B, Hq, Hkv, D, page, T, S = 1, 4, 2, 8, 8, 64, 24
    rng = np.random.default_rng(1)
    k = rng.standard_normal((B, T, Hkv, D), np.float32)
    v = rng.standard_normal((B, T, Hkv, D), np.float32)
    q_full = rng.standard_normal((B, T, Hq, D), np.float32)
    full = jax_ref_flash_prefill(
        jnp.asarray(q_full).transpose(0, 2, 1, 3),
        jnp.asarray(k).transpose(0, 2, 1, 3),
        jnp.asarray(v).transpose(0, 2, 1, 3)).transpose(0, 2, 1, 3)
    got = flash_prefill_paged(
        torch.tensor(q_full[:, T - S:]),
        torch.tensor(k).reshape(T // page, page, Hkv, D),
        torch.tensor(v).reshape(T // page, page, Hkv, D),
        torch.arange(T // page, dtype=torch.int32)[None],
        torch.tensor([T - S], dtype=torch.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(full[:, T - S:]),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("shape", ["context_chunk", "tails"])
@pytest.mark.parametrize("fault", ["faithful", "wrong_page",
                                   "one_key_too_many", "start_one_too_small"])
def test_main_shape_prefill_bf16_tolerance_separates_faults(fault, shape):
    """``MAIN_SHAPE_PREFILL_BF16_TOL``, which the card holds the bf16
    ``flash_prefill_paged`` kernel to at the chunked main path's shapes
    (a 200-token chunk at start 800; four 40-token tails at start 992),
    passes a result rounded through another path (fp64) and fails one wrong
    page per sequence, the causal boundary one key too far (every query
    sees the key after its own: in the plain version, start + 1) and a
    start one too small (every query loses its own key)."""
    Hq, Hkv, D, page, P = 32, 8, 128, 16, 2049
    B, S, npages, st0 = {"context_chunk": (1, 200, 64, 800),
                         "tails": (4, 40, 128, 992)}[shape]
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((B, S, Hq, D), np.float32))
    kp, vp = (torch.tensor(rng.standard_normal((P, page, Hkv, D),
                                               np.float32))
              for _ in range(2))
    q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
    live = -(-(st0 + S) // page)
    bt = torch.zeros((B, npages), dtype=torch.int32)
    bt[:, :live] = torch.tensor(
        rng.permutation(np.arange(1, P))[:B * live].reshape(B, live))
    start = torch.full((B,), st0, dtype=torch.int32)
    want = ref_paged_prefill(q, kp, vp, bt, start).float()
    if fault == "faithful":
        got = ref_paged_prefill(q.double(), kp.double(), vp.double(), bt,
                                start)
    elif fault == "one_key_too_many":
        got = ref_paged_prefill(q, kp, vp, bt, start + 1)
    elif fault == "start_one_too_small":
        got = ref_paged_prefill(q, kp, vp, bt, start - 1)
    else:
        bad = bt.clone()
        for b in range(B):
            j = int(rng.integers(0, st0 // page))
            bad[b, j] = (bt[b, j] % (P - 1)) + 1
        got = ref_paged_prefill(q, kp, vp, bad, start)
    got = got.bfloat16().float()
    close = torch.allclose(got, want, **MAIN_SHAPE_PREFILL_BF16_TOL)
    assert close == (fault == "faithful"), (fault, (got - want).abs().max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [
    # B, S, Hkv, D, page, pool  (tests/test_kernels.py paged_write cases)
    (3, 64, 2, 32, 16, 24),
    (1, 32, 4, 64, 8, 12),
    (2, 128, 1, 128, 32, 16),
], ids=str)
def test_paged_write_plain_bitwise_vs_pallas(case, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    B, S, H, D, page, P = case
    npages = S // page
    rng = np.random.default_rng(1)
    nk, nv = (rng.standard_normal((B, S, H, D), np.float32) for _ in range(2))
    kp, vp = (rng.standard_normal((P, page, H, D), np.float32)
              for _ in range(2))
    bt = rng.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    nvalid = rng.integers(1, npages + 1, B).astype(np.int32)
    ko, vo = ref_pallas_paged_write(
        jnp.asarray(nk, jdt), jnp.asarray(nv, jdt), jnp.asarray(kp, jdt),
        jnp.asarray(vp, jdt), jnp.asarray(bt), jnp.asarray(nvalid),
        interpret=True)
    tk, tv = torch.tensor(kp).to(tdt), torch.tensor(vp).to(tdt)
    before = tk.clone()
    got_k, got_v = paged_write(torch.tensor(nk).to(tdt),
                               torch.tensor(nv).to(tdt), tk, tv, bt, nvalid)
    assert got_k is tk and got_v is tv                     # in place
    np.testing.assert_array_equal(tk.float().numpy(), np.asarray(ko, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(), np.asarray(vo, np.float32))
    written = {int(bt[b, j]) for b in range(B) for j in range(nvalid[b])}
    for p in set(range(P)) - written:                      # untouched pages
        assert torch.equal(tk[p], before[p])


@pytest.mark.parametrize("fault", ["faithful", "wrong_page", "next_page",
                                   "one_key_too_many"])
def test_main_shape_bf16_tolerance_separates_faults(fault):
    """``MAIN_SHAPE_BF16_TOL``, which the card holds the bf16 kernel to at
    the Llama-3.1-8B decode shape, passes a result rounded through another
    path (fp64) and fails one wrong page per sequence or one extra key."""
    B, Hq, Hkv, D, page, npages, P = 8, 32, 8, 128, 16, 256, 2049
    rng = np.random.default_rng(0)
    q, kp, vp = (torch.tensor(rng.standard_normal(s, np.float32)).bfloat16()
                 for s in ((B, Hq, D), (P, page, Hkv, D), (P, page, Hkv, D)))
    bt = torch.tensor(rng.integers(1, P, (B, npages)), dtype=torch.int32)
    ln = torch.tensor(rng.integers(1024, 4097, B), dtype=torch.int32)
    want = ref_paged_decode(q, kp, vp, bt, ln).float()
    live = [int(rng.integers(0, int(n) // page)) for n in ln]
    if fault == "faithful":
        got = ref_paged_decode(q.double(), kp.double(), vp.double(), bt, ln)
    elif fault == "one_key_too_many":
        got = ref_paged_decode(q, kp, vp, bt, ln + 1)
    else:
        bad = bt.clone()
        for b, j in enumerate(live):
            bad[b, j] = (bt[b, j] % (P - 1)) + 1 if fault == "wrong_page" \
                else bt[b, j + 1]
        got = ref_paged_decode(q, kp, vp, bad, ln)
    got = got.bfloat16().float()
    close = torch.allclose(got, want, **MAIN_SHAPE_BF16_TOL)
    assert close == (fault == "faithful"), (fault, (got - want).abs().max())


def test_paged_write_duplicate_target_pages_raise():
    """GPU blocks run in parallel, so two valid entries naming one pool page
    are refused on the host before any launch."""
    nk = torch.zeros((2, 16, 1, 32))
    kp = torch.zeros((8, 8, 1, 32))
    bt = np.array([[1, 2], [3, 2]], np.int32)
    with pytest.raises(ValueError, match="more than once"):
        paged_write(nk, nk.clone(), kp, kp.clone(), bt, np.array([2, 2]))
    # the same page past n_valid is not a target: allowed
    paged_write(nk, nk.clone(), kp, kp.clone(), bt, np.array([2, 1]))


def test_wrappers_refuse_devices_they_have_no_kernel_for():
    q = torch.zeros((1, 2, 32), device="meta")
    kp = torch.zeros((4, 8, 1, 32), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(q, kp, kp, bt, bt[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill_paged(q[:, None], kp, kp, bt, bt[:, 0])
    with pytest.raises(ValueError, match="unsupported device"):
        paged_write(torch.zeros((1, 8, 1, 32), device="meta"),
                    torch.zeros((1, 8, 1, 32), device="meta"), kp, kp,
                    np.ones((1, 1), np.int32), np.ones((1,), np.int32))
    qd = torch.zeros((1, 4, 8, 32), device="meta")
    kd = torch.zeros((1, 2, 8, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_prefill(qd, kd, kd)
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(qd, kd, kd)


@pytest.mark.parametrize("spec", ["f16", "int32", "head_dim48", "hq6_hkv4",
                                  "group32", "mixed_dtypes"])
@pytest.mark.parametrize("entry", ["flash_prefill", "flash_attention"])
def test_flash_wrappers_refuse_what_the_kernel_does_not_take(entry, spec):
    """Off the CPU, the dense wrappers refuse fp16 and integer tensors,
    head_dim 48, Hq not a multiple of Hkv, and a query group above 16, by
    name, before they look at the device (meta tensors here)."""
    hq, hkv, d, dtype, kdtype = 4, 2, 32, torch.float32, None
    if spec == "f16":
        dtype = torch.float16
    elif spec == "int32":
        dtype = torch.int32
    elif spec == "head_dim48":
        d = 48
    elif spec == "hq6_hkv4":
        hq, hkv = 6, 4
    elif spec == "group32":
        hq, hkv = 32, 1
    else:
        kdtype = torch.bfloat16
    q = torch.zeros((1, hq, 8, d), dtype=dtype, device="meta")
    k = torch.zeros((1, hkv, 8, d), dtype=kdtype or dtype, device="meta")
    match = {"head_dim48": "head_dim 48", "hq6_hkv4": "Hq=6 Hkv=4",
             "group32": "query group"}.get(spec, "dtypes")
    with pytest.raises(ValueError, match=match):
        if entry == "flash_prefill":
            flash_prefill(q, k, k)
        else:
            flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            k.transpose(1, 2))


def test_build_rebuilds_every_kernel_when_a_shared_header_changes(
        tmp_path, monkeypatch):
    """``_build._stale`` counts every ``csrc/*.cuh`` as a source of every
    kernel: touching a shared header makes both libraries stale, touching
    one ``.cu`` only its own."""
    import os
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    out.mkdir()
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    for name in ("one.cu", "two.cu", "tile.cuh"):
        (csrc / name).write_text("//\n")
        os.utime(csrc / name, (100, 100))
    for lib in ("libone.so", "libtwo.so"):
        (out / lib).write_text("")
        os.utime(out / lib, (200, 200))
    assert not _build._stale("one") and not _build._stale("two")
    os.utime(csrc / "one.cu", (300, 300))
    assert _build._stale("one") and not _build._stale("two")
    os.utime(out / "libone.so", (400, 400))
    os.utime(csrc / "tile.cuh", (500, 500))
    assert _build._stale("one") and _build._stale("two")


@pytest.mark.parametrize("spec", ["head_dim48", "group32"])
@pytest.mark.parametrize("entry", ["paged_decode", "flash_prefill_paged"])
def test_paged_wrappers_refuse_what_the_kernel_does_not_take(entry, spec):
    """Off the CPU, the paged wrappers refuse head_dim 48 and a query group
    above 16 (32 query heads over one kv head) by name, before they look at
    the device (meta tensors here); group 16 and head_dim 256 pass the shape
    checks and reach the device check."""
    hq, d = (4, 48) if spec == "head_dim48" else (32, 32)
    kp = torch.zeros((4, 8, 1, d), device="meta")
    bt = torch.zeros((1, 1), dtype=torch.int32, device="meta")
    match = "head_dim 48" if spec == "head_dim48" else "query group"
    q = torch.zeros((1, hq, d), device="meta")
    with pytest.raises(ValueError, match=match):
        if entry == "paged_decode":
            paged_decode_attention(q, kp, kp, bt, bt[:, 0])
        else:
            flash_prefill_paged(q[:, None], kp, kp, bt, bt[:, 0])
    q = torch.zeros((1, 16, 256), device="meta")
    kp = torch.zeros((4, 8, 1, 256), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        if entry == "paged_decode":
            paged_decode_attention(q, kp, kp, bt, bt[:, 0])
        else:
            flash_prefill_paged(q[:, None], kp, kp, bt, bt[:, 0])


# ----------------------------------------------------------------------
# the split over keys of the tensor-core flash_prefill_paged

def _partial_paged_prefill(q, k_pages, v_pages, block_tables, start, lo, hi,
                           softcap=0.0):
    """One part of a split key range: the unnormalised output, max and
    denominator of ``ref_paged_prefill`` over keys [lo, hi) only, (B, S, Hq,
    D) and (B, S, Hq), fp32; a row with no visible key there gets max -1e30,
    denominator 0 and output 0 (what the kernel's part writes)."""
    B, S, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    npages = block_tables.shape[1]
    g, T = Hq // Hkv, npages * page
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, T, Hkv, D).float()
    v = v_pages[bt].reshape(B, T, Hkv, D).float()
    qg = (q.float() * D ** -0.5).reshape(B, S, Hkv, g, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    qpos = start[:, None] + torch.arange(S, dtype=torch.int32)[None]
    kpos = torch.arange(T, dtype=torch.int32)
    mask = ((kpos[None, None, :] <= qpos[:, :, None])
            & (kpos >= lo) & (kpos < hi))[:, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p, v).reshape(B, S, Hq, D)
    return (o, m.permute(0, 3, 1, 2).reshape(B, S, Hq),
            p.sum(dim=-1).permute(0, 3, 1, 2).reshape(B, S, Hq))


def _split_parts(args, n, softcap=0.0):
    T = args[3].shape[1] * args[1].shape[1]
    bounds = [round(i * T / n) for i in range(n + 1)]
    parts = [_partial_paged_prefill(*args, lo, hi, softcap=softcap)
             for lo, hi in zip(bounds, bounds[1:])]
    return [torch.stack(x) for x in zip(*parts)]


#: narrow copies (Hq 8, Hkv 2) of the chunked main path's chunk forwards
#: (chip_smoke.MAIN_CHUNKS: 200-token chunks, the four 40- and 72-token
#: tails past 992 cached tokens), each table as wide as the scheduler
#: buckets it; B, Hq, Hkv, D, page, npages, pool, S, start
NARROW_CHUNKS = [(1, 8, 2, 128, 16, 16, 300, 200, 0),
                 (1, 8, 2, 128, 16, 64, 300, 200, 800),
                 (4, 8, 2, 128, 16, 128, 300, 40, 992),
                 (4, 8, 2, 128, 16, 128, 300, 72, 992)]


def _narrow_chunk_inputs(case, dtype=torch.float32, seed=0):
    B, Hq, Hkv, D, page, npages, P, S, st0 = case
    rng = np.random.default_rng(seed)
    q = torch.tensor(rng.standard_normal((B, S, Hq, D), np.float32))
    kp, vp = (torch.tensor(rng.standard_normal((P, page, Hkv, D),
                                               np.float32))
              for _ in range(2))
    live = -(-(st0 + S) // page)
    bt = torch.zeros((B, npages), dtype=torch.int32)
    bt[:, :live] = torch.tensor(
        rng.permutation(np.arange(1, P))[:B * live].reshape(B, live))
    start = torch.full((B,), st0, dtype=torch.int32)
    return q.to(dtype), kp.to(dtype), vp.to(dtype), bt, start


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("case", PAGED_PREFILL_CASES + NARROW_CHUNKS,
                         ids=str)
def test_split_key_ranges_merge_to_the_unsplit_plain_version(case, n):
    """``ref_paged_prefill``'s key range cut into 2, 3 or 7 parts, each
    part's partial output, max and denominator merged by
    ``ref_merge_splits``, equals the unsplit plain version in fp32 within
    1e-6. Parts past every row's causal boundary see no key."""
    if len(case) == 8:
        args = tuple(torch.tensor(a) for a in _prefill_inputs(case))
    else:
        args = _narrow_chunk_inputs(case)
    for softcap in (0.0, 30.0):
        o, m, l_ = _split_parts(args, n, softcap)
        got = ref_merge_splits(o, m, l_)
        want = ref_paged_prefill(*args, softcap=softcap)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_merge_of_parts_with_no_visible_key():
    """A part in which no row sees a key (max -1e30, denominator 0, output
    0) changes nothing; a row that sees no key in any part merges to
    exactly 0."""
    args = _narrow_chunk_inputs(NARROW_CHUNKS[1])      # start 800, S 200
    o, m, l_ = _split_parts(args, 4)
    # keys 768.. of the 1024-key table: the last part, [768, 1024), holds
    # every row's newest keys; the empty part is made by hand
    empty = (torch.zeros_like(o[:1]), torch.full_like(m[:1], -1e30),
             torch.zeros_like(l_[:1]))
    want = ref_paged_prefill(*args)
    for at in (0, 2, 4):
        parts = [torch.cat([x[:at], e, x[at:]])
                 for x, e in zip((o, m, l_), empty)]
        torch.testing.assert_close(ref_merge_splits(*parts), want,
                                   atol=1e-6, rtol=1e-6)
    blind = (o.clone(), m.clone(), l_.clone())
    blind[0][:, 0, 5] = 0.0
    blind[1][:, 0, 5] = -1e30
    blind[2][:, 0, 5] = 0.0
    got = ref_merge_splits(*blind)
    assert not got[0, 5].any()
    torch.testing.assert_close(got[0, 6:], want[0, 6:], atol=1e-6, rtol=1e-6)


def _blocks(B, S, Hq, Hkv):
    return B * Hkv * -(-(Hq // Hkv) * S // ROW_TILE)


def test_choose_splits():
    """n = 1 when the grid already fills the 132 SMs; never more parts than
    key tiles of the table (so none is planned under one key tile) or
    ``MAX_SPLITS``; at least 132 blocks for the B = 1 40-token tail and the
    200-token chunks at Llama-3.1-8B's heads."""
    sms = 132
    assert choose_splits(4, 72, 32, 8, 2048, sms) == 1      # 160 blocks
    assert choose_splits(8, 200, 32, 8, 1024, sms) == 1
    for B, S, cap in [(1, 40, 2048), (1, 200, 256), (1, 200, 512),
                      (1, 200, 1024), (1, 200, 2048)]:
        n = choose_splits(B, S, 32, 8, cap, sms)
        assert _blocks(B, S, 32, 8) * n >= sms, (B, S, n)
    for B in (1, 2, 4):
        for S in (1, 5, 40, 72, 200):
            for Hq, Hkv in ((32, 8), (32, 2), (8, 1), (16, 16)):
                for cap in (16, 64, 100, 1024, 4096):
                    n = choose_splits(B, S, Hq, Hkv, cap, sms)
                    assert 1 <= n <= MAX_SPLITS
                    assert n == 1 or n <= -(-cap // KEY_TILE)
                    if _blocks(B, S, Hq, Hkv) >= sms:
                        assert n == 1


# ----------------------------------------------------------------------
# the split over keys of the tensor-core paged_decode

def _decode_part_bounds(lengths, n, p):
    """Keys [lo, hi) of part p of n, per sequence, as the kernel computes
    them on the card: each length's ceil(len / 64) key tiles shared out as
    [p * nt // n, (p + 1) * nt // n), cut at the length."""
    tile = decode_mod.KEY_TILE
    nt = (lengths.clamp_min(0) + tile - 1) // tile
    lo = p * nt // n * tile
    hi = torch.minimum((p + 1) * nt // n * tile, lengths)
    return lo, hi


def _partial_paged_decode(q, k_pages, v_pages, block_tables, lengths, lo, hi,
                          softcap=0.0):
    """One part of a split key range: the unnormalised output, max and
    denominator of ``ref_paged_decode`` over keys [lo[b], hi[b]) only,
    (B, Hq, D) and (B, Hq), fp32; a part that sees no key gets max -1e30,
    denominator 0 and output 0 (what the kernel's part writes)."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    npages = block_tables.shape[1]
    g, T = Hq // Hkv, npages * page
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, T, Hkv, D).float()
    v = v_pages[bt].reshape(B, T, Hkv, D).float()
    qg = q.reshape(B, Hkv, g, D).float() * D ** -0.5
    s = torch.einsum("bhgd,bthd->bhgt", qg, k)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    t = torch.arange(T)[None]
    mask = ((t < lengths[:, None]) & (t >= lo[:, None])
            & (t < hi[:, None]))[:, None, None]
    s = torch.where(mask, s, -1e30)
    m = s.amax(dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    o = torch.einsum("bhgt,bthd->bhgd", p, v)
    return o.reshape(B, Hq, D), m.reshape(B, Hq), p.sum(dim=-1).reshape(B, Hq)


@pytest.mark.parametrize("n", [2, 3, 7])
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_decode_split_key_ranges_merge_to_the_unsplit_plain_version(case, n):
    """``ref_paged_decode``'s keys cut into 2, 3 or 7 parts on the kernel's
    key-tile bounds, each part's partial output, max and denominator merged
    by ``ref_merge_splits``, equal the unsplit plain version in fp32 within
    1e-6: at random lengths, at lengths of 1, 17, 64 and 65 (not a multiple
    of the tile) and at the table's capacity. Parts that see no key (more
    parts than key tiles) change nothing."""
    q, kp, vp, bt, ln = (torch.tensor(a) for a in _decode_inputs(case))
    cap = bt.shape[1] * kp.shape[1]
    empty = 0
    for lengths in (ln, *(torch.full_like(ln, min(x, cap))
                          for x in (1, 17, 64, 65, cap))):
        for softcap in (0.0, 30.0):
            parts = []
            for p in range(n):
                lo, hi = _decode_part_bounds(lengths, n, p)
                empty += int((hi <= lo).sum())
                parts.append(_partial_paged_decode(q, kp, vp, bt, lengths,
                                                   lo, hi, softcap))
            got = ref_merge_splits(*(torch.stack(x) for x in zip(*parts)))
            want = ref_paged_decode(q, kp, vp, bt, lengths, softcap=softcap)
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    assert empty > 0                    # length 1: n - 1 parts see no key


def test_decode_choose_splits():
    """n = 1 once B * Hkv blocks leave at most a sixteenth of the SMs idle;
    otherwise the most parts that fit one wave of two blocks an SM, at most
    ``MAX_SPLITS`` and one part per ``MIN_PART_TILES`` key tiles of the
    table's capacity (so none is planned under that). The B=8 main shape
    and the engine's B=4 step split in 4, chatglm3-6b's heads (8 blocks) at
    4096 keys in 8; 128 blocks do not split (the sweep in PERF.md)."""
    choose, sms = decode_mod.choose_splits, 132
    assert choose(8, 8, 4096, sms) == 4                   # the main shape
    assert choose(4, 8, 2048, sms) == 4                   # the engine's
    assert choose(4, 2, 4096, sms) == 8                   # chatglm3-6b
    assert choose(1, 8, 2048, sms) == 4
    assert choose(16, 8, 2048, sms) == 1                  # 128 blocks
    assert choose(32, 8, 4096, sms) == 1
    assert choose(1, 1, 16, sms) == 1                     # one key tile
    assert choose(1, 1, 100, sms) == 1
    assert choose(1, 1, 1 << 20, sms) == decode_mod.MAX_SPLITS
    per_part = decode_mod.KEY_TILE * decode_mod.MIN_PART_TILES
    for B in (1, 2, 3, 4, 8, 16, 40):
        for Hkv in (1, 2, 8, 16):
            for cap in (8, 16, 64, 65, 1024, 2048, 4096, 1 << 16):
                n = choose(B, Hkv, cap, sms)
                assert 1 <= n <= min(decode_mod.MAX_SPLITS,
                                     max(1, -(-cap // per_part)))
                if B * Hkv >= sms - sms // 16:
                    assert n == 1
                elif n > 1:
                    assert B * Hkv * n <= 2 * sms
                    assert n == min(2 * sms // (B * Hkv),
                                    decode_mod.MAX_SPLITS,
                                    -(-cap // per_part))


@pytest.mark.parametrize("spec", ["zero", "seventeen", "f32", "bf16_d32"])
def test_decode_wrapper_refuses_splits_it_cannot_run(spec):
    """Off the CPU, ``splits=`` outside 1..16, or above 1 where the kernel
    does not split (fp32, bf16 at head_dim 32), is refused by name before
    the device is looked at (meta tensors here); 16 passes to the device
    check."""
    dtype, d, n = {"zero": (torch.bfloat16, 128, 0),
                   "seventeen": (torch.bfloat16, 128, 17),
                   "f32": (torch.float32, 128, 2),
                   "bf16_d32": (torch.bfloat16, 32, 2)}[spec]
    q = torch.zeros((2, 8, d), dtype=dtype, device="meta")
    kp = torch.zeros((4, 16, 2, d), dtype=dtype, device="meta")
    bt = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match=f"splits={n}"):
        paged_decode_attention(q, kp, kp, bt, bt[:, 0], splits=n)
    with pytest.raises(ValueError, match="unsupported device"):
        paged_decode_attention(q, kp, kp, bt, bt[:, 0],
                               splits=16 if dtype == torch.bfloat16
                               and d >= 64 else 1)


def test_profiler_counts_each_merge_with_its_caller():
    """The shared merge kernel is a template on a tag naming its caller
    (``csrc/merge_splits.cuh``); the profiler's kernel classes count it
    with that caller, by the demangled name each source instantiates."""
    import re

    from repro_torch.launch.profile import _kernel_class
    seen = {}
    for name in ("paged_decode", "flash_prefill_paged"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        tags = set(re.findall(r"merge_splits::launch<(\w+)>", src))
        assert len(tags) == 1, (name, tags)
        tag = tags.pop()
        kernel = (f"void merge_splits::merge_splits_kernel<(anonymous "
                  f"namespace)::{tag}>(float const*, float const*, "
                  f"__nv_bfloat16*, int, long long, int)")
        seen[name] = _kernel_class(kernel)
    assert seen == {"paged_decode": "paged_decode",
                    "flash_prefill_paged": "flash_prefill_paged"}
    assert _kernel_class("void (anonymous namespace)::paged_decode_tc_kernel"
                         "<128>(__nv_bfloat16 const*)") == "paged_decode"


def _decode_tc_model(q, k_pages, v_pages, block_tables, lengths, variant,
                     softcap=0.0):
    """A test-local copy of the plain algorithm as the tensor-core decode
    kernel does it, unsplit: 64-key tiles whose four 16-key chunks go to
    four warps, each warp an online softmax of its own (the fp32 product of
    bf16 q and k times the scale, the softcap, the mask, the running max
    after each chunk, P taken against it and rounded for the bf16 product
    P @ V: to bf16 alone, with the denominator summing P as rounded, or as
    a bf16 hi/lo pair), then the four warps combined in fp32. The running
    rescale is taken in closed form (a chunk's P V and P sum times
    exp(m_chunk - m_final)), so one product covers every chunk. Returns
    (B, Hq, D) fp32."""
    B, Hq, D = q.shape
    P, page, Hkv, _ = k_pages.shape
    G, T = Hq // Hkv, block_tables.shape[1] * page
    nt = -(-T // 64)
    bt = block_tables.long()
    k = k_pages[bt].reshape(B, T, Hkv, D).permute(0, 2, 1, 3).float()
    v = v_pages[bt].reshape(B, T, Hkv, D).permute(0, 2, 1, 3).float()
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, nt * 64 - T))
            for x in (k, v))
    s = torch.einsum("bhgd,bhtd->bhgt", q.reshape(B, Hkv, G, D).float(),
                     k) * D ** -0.5
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    vis = (torch.arange(nt * 64)[None] < lengths[:, None])[:, None, None]
    s = torch.where(vis, s, -1e30).reshape(B, Hkv, G, nt, 4, 16)
    vis = vis.reshape(B, 1, 1, nt, 4, 16)
    m = s.amax(-1).cummax(dim=3).values            # after each chunk
    p = torch.where(vis, torch.exp(s - m[..., None]), 0.0)
    hi = p.bfloat16().float()
    if variant == "bf16":
        pv, psum = hi, hi.sum(-1)
    else:
        pv, psum = hi + (p - hi).bfloat16().float(), p.sum(-1)
    c = torch.exp(m - m[:, :, :, -1:])            # to the warp's final max
    den = (psum * c).sum(3)                        # (B, Hkv, G, 4)
    o = torch.einsum("bhgjwk,bhjwkd->bhgwd", pv * c[..., None],
                     v.reshape(B, Hkv, nt, 4, 16, D))
    mw = m[:, :, :, -1]
    w = torch.exp(mw - mw.amax(-1, keepdim=True))
    num = (w[..., None] * o).sum(3)
    tot = (w * den).sum(3)
    out = torch.where(tot[..., None] > 0,
                      num / tot.clamp_min(1e-30)[..., None], 0.0)
    return out.reshape(B, Hq, D)


#: the decode shapes the card holds to ``MAIN_SHAPE_BF16_TOL``: B, Hq, Hkv,
#: npages, pool, lengths: chip_smoke's B=8 main shape (1k-4k tokens), the
#: engine's own B=4 step (~1.0-1.1k), chatglm3-6b's heads, and the main
#: widths at the short lengths the card tests also draw (random lengths
#: from 1 up); D 128, page 16
DECODE_TC_SHAPES = {"main": (8, 32, 8, 256, 2049, (1024, 4097)),
                    "engine": (4, 32, 8, 128, 2049, (1032, 1101)),
                    "chatglm": (4, 32, 2, 256, 1025, (1024, 4097)),
                    "main_short": (4, 32, 8, 128, 2049, [(1, 2, 3, 5),
                                                         (8, 16, 17, 33)])}


@pytest.mark.parametrize("variant", ["bf16", "hi_lo"])
@pytest.mark.parametrize("shape", [*DECODE_TC_SHAPES, *[
    f"short_{c}" for c in PAGED_CASES if c[3] >= 64]])
def test_p_for_the_decode_tensor_cores_needs_the_hi_lo_pair(shape, variant):
    """Evidence for the decode kernel's P @ V: P rounded to bf16 alone (the
    denominator summing P as rounded) holds ``MAIN_SHAPE_BF16_TOL`` where
    rows see 1k-4k keys (the main, engine and chatglm3-6b decode shapes)
    and the reference's 2e-2 at its cases with 1-64 keys, but not the
    main-shape tolerance at the main widths where rows see a few dozen keys
    or fewer, which the card's tests draw; P kept as a bf16 hi/lo pair
    holds every one, so the kernel takes the pair."""
    if shape in DECODE_TC_SHAPES:
        B, Hq, Hkv, npages, P, lens = DECODE_TC_SHAPES[shape]
        rng = np.random.default_rng(0)
        q, kp, vp = (torch.tensor(rng.standard_normal(s, np.float32))
                     .bfloat16() for s in ((B, Hq, 128), (P, 16, Hkv, 128),
                                           (P, 16, Hkv, 128)))
        bt = torch.tensor(rng.integers(1, P, (B, npages)), dtype=torch.int32)
        ln = ([torch.tensor(x, dtype=torch.int32) for x in lens]
              if isinstance(lens, list) else
              [torch.tensor(rng.integers(*lens, B), dtype=torch.int32)])
        tol = MAIN_SHAPE_BF16_TOL
    else:
        case = next(c for c in PAGED_CASES if shape == f"short_{c}")
        q, kp, vp, bt, _ = (torch.tensor(a) for a in _decode_inputs(case))
        q, kp, vp = q.bfloat16(), kp.bfloat16(), vp.bfloat16()
        cap = bt.shape[1] * kp.shape[1]
        ln = [torch.full((q.shape[0],), min(x, cap), dtype=torch.int32)
              for x in (1, 2, 3, 17, 64)]
        tol = {"atol": 2e-2, "rtol": 2e-2}
    holds = True
    for lengths in ln:
        for softcap in (0.0, 30.0):
            want = ref_paged_decode(q, kp, vp, bt, lengths,
                                    softcap=softcap).float()
            got = _decode_tc_model(q, kp, vp, bt, lengths, variant, softcap)
            got = got.bfloat16().float()
            assert torch.allclose(got, want, atol=2e-2, rtol=2e-2)
            holds &= torch.allclose(got, want, **tol)
    assert holds == (variant == "hi_lo" or shape != "main_short"), \
        (shape, variant)


# ----------------------------------------------------------------------
# P rounded for the tensor cores' P @ V

def _online_tc_model(q, k, v, kvis, variant, softcap=0.0):
    """A test-local copy of the plain algorithm as the tensor-core tile does
    it: 64-key tiles, the fp32 product of bf16 q and k times the scale, the
    softcap, the mask, the online softmax in fp32, and P rounded for the
    bf16 product P @ V, either to bf16 alone or as a bf16 hi/lo pair (hi =
    bf16(P), lo = bf16(P - hi)). q (..., R, D), k/v (..., T, D);
    kvis(t0, t1) -> a mask broadcasting to (..., R, t1 - t0). Returns the
    fp32 output (0 for a row that sees no key)."""
    D, T = q.shape[-1], k.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -1e30)
    den = torch.zeros(q.shape[:-1])
    o = torch.zeros(q.shape)
    for t0 in range(0, T, 64):
        t1 = min(T, t0 + 64)
        s = (qf @ kf[..., t0:t1, :].transpose(-1, -2)) * D ** -0.5
        if softcap:
            s = torch.tanh(s / softcap) * softcap
        vis = kvis(t0, t1)
        s = torch.where(vis, s, -1e30)
        mn = torch.maximum(m, s.amax(-1))
        p = torch.where(vis, torch.exp(s - mn[..., None]), 0.0)
        c = torch.exp(m - mn)
        den = den * c + p.sum(-1)
        hi = p.bfloat16().float()
        pv = hi @ vf[..., t0:t1, :]
        if variant == "hi_lo":
            pv = pv + (p - hi).bfloat16().float() @ vf[..., t0:t1, :]
        o = o * c[..., None] + pv
        m = mn
    return torch.where(den[..., None] > 0,
                       o / den.clamp_min(1e-30)[..., None], 0.0)


@pytest.mark.parametrize("cap", [20.0, 30.0, 50.0])
def test_tensor_core_softcap_formula_is_within_rounding_of_tanh(cap):
    """The tensor-core tile computes the softcap as (1 - 2 / (2^(x k) + 1))
    * cap with k = 2 log2(e) / cap (csrc/attn_tile.cuh:soft_cap); in fp32 it
    stays within 3e-7 * cap of tanh(x / cap) * cap (1.5e-5 at cap 50, a
    relative change of p far below a bf16 step) and saturates at +-cap."""
    x = torch.linspace(-40 * cap, 40 * cap, 400001)
    k = torch.tensor(2 * 1.4426950408889634 / cap, dtype=torch.float32)
    got = (1 - 2 / (torch.exp2(x * k) + 1)) * cap
    want = torch.tanh(x.double() / cap) * cap
    assert (got.double() - want).abs().max() <= 3e-7 * cap
    big = torch.tensor([-1e30, 1e30])
    assert torch.equal((1 - 2 / (torch.exp2(big * k) + 1)) * cap,
                       torch.tensor([-cap, cap]))


@pytest.mark.parametrize("variant", ["bf16", "hi_lo"])
@pytest.mark.parametrize("shape", ["llama", "gemma", *[
    f"chunk_{c[7]}_{c[8]}_b{c[0]}" for c in NARROW_CHUNKS]])
def test_p_for_the_tensor_cores_needs_the_hi_lo_pair(shape, variant):
    """Evidence for the tensor-core tile's P @ V: P rounded to bf16 alone
    stays within the reference's 2e-2 but not within the main-shape
    tolerances wherever early rows see few keys and have outputs near 1
    (the dense FLASH_TOL_SHAPES, the chunk at start 0); P kept as a bf16
    hi/lo pair holds them everywhere. Deep in the context (rows of ~1000
    keys) bf16 alone would hold ``MAIN_SHAPE_PREFILL_BF16_TOL``; the shared
    tile keeps the pair."""
    if shape in FLASH_TOL_SHAPES:
        Hq, Hkv, S, window, softcap, qscale = FLASH_TOL_SHAPES[shape]
        rng = np.random.default_rng(0)
        q = torch.tensor(rng.standard_normal((1, Hq, S, 128), np.float32)
                         * qscale).bfloat16()
        k, v = (torch.tensor(rng.standard_normal((1, Hkv, S, 128),
                                                 np.float32)).bfloat16()
                for _ in range(2))
        want = ref_flash_prefill(q, k, v, window=window,
                                 softcap=softcap).float()
        i = torch.arange(S)[:, None]

        def kvis(t0, t1):
            j = torch.arange(t0, t1)[None]
            return (j <= i) & (j > i - window) if window else j <= i

        qg = q.reshape(1, Hkv, Hq // Hkv, S, 128)
        got = _online_tc_model(qg, k[:, :, None], v[:, :, None], kvis,
                               variant, softcap).reshape(1, Hq, S, 128)
        main = MAIN_SHAPE_FLASH_BF16_TOL
    else:
        case = next(c for c in NARROW_CHUNKS
                    if shape == f"chunk_{c[7]}_{c[8]}_b{c[0]}")
        q, kp, vp, bt, start = _narrow_chunk_inputs(case, torch.bfloat16)
        B, S, Hq, D = q.shape
        Hkv, T = kp.shape[2], bt.shape[1] * kp.shape[1]
        want = ref_paged_prefill(q, kp, vp, bt, start).float()
        k = kp[bt.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3)
        v = vp[bt.long()].reshape(B, T, Hkv, D).permute(0, 2, 1, 3)
        qg = q.reshape(B, S, Hkv, Hq // Hkv, D).permute(0, 2, 3, 1, 4)
        qpos = (start[:, None] + torch.arange(S)[None])[:, None, None, :,
                                                        None]

        def kvis(t0, t1):
            return torch.arange(t0, t1) <= qpos

        got = _online_tc_model(qg, k[:, :, None], v[:, :, None], kvis,
                               variant)
        got = got.permute(0, 3, 1, 2, 4).reshape(B, S, Hq, D)
        main = MAIN_SHAPE_PREFILL_BF16_TOL
    few_keys = shape in FLASH_TOL_SHAPES or shape.startswith("chunk_200_0_")
    got = got.bfloat16().float()
    assert torch.allclose(got, want, atol=2e-2, rtol=2e-2)
    holds = torch.allclose(got, want, **main)
    assert holds == (variant == "hi_lo" or not few_keys), \
        (shape, variant, (got - want).abs().max())


# ----------------------------------------------------------------------
# dense flash_prefill

# B, Hq, Hkv, S, T, D, window, softcap  (tests/test_kernels.py FLASH_CASES;
# causal, as there)
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, 0, 0.0),
    (1, 8, 8, 256, 256, 128, 0, 0.0),       # MHA
    (1, 8, 1, 192, 192, 64, 0, 0.0),        # MQA, non-pow2 seq
    (2, 4, 2, 128, 128, 64, 64, 0.0),       # sliding window
    (1, 4, 2, 256, 256, 128, 0, 50.0),      # softcap (gemma2)
    (1, 2, 1, 64, 320, 64, 0, 0.0),         # cross-len
    (1, 4, 4, 96, 96, 32, 32, 30.0),        # window + softcap, odd sizes
]
# B, Hq, Hkv, S, T, D, causal, window, softcap: what FLASH_CASES leave out
FLASH_EDGES = {
    "no_visible_key": (1, 2, 1, 64, 16, 64, True, 8, 0.0),
    "noncausal_s_lt_t": (2, 4, 2, 48, 80, 32, False, 0, 0.0),
    "noncausal_s_gt_t_window": (1, 4, 2, 80, 48, 32, False, 16, 0.0),
    "window_ge_t": (1, 4, 2, 64, 64, 32, True, 100, 0.0),
    "window_1": (1, 4, 1, 40, 40, 32, True, 1, 0.0),
    "s97_t100": (1, 4, 2, 97, 100, 64, True, 0, 0.0),
    "s97_t100_window_softcap": (1, 4, 2, 97, 100, 64, True, 16, 20.0),
    "group16": (1, 16, 1, 64, 64, 32, True, 0, 0.0),
    "head_dim256": (1, 2, 1, 32, 32, 256, True, 0, 0.0),
}
#: cases where some query row sees no key (the reference's oracle gives
#: mean(v) there, the Pallas kernel and the port 0)
FLASH_MASKED_ROWS = {"no_visible_key", "noncausal_s_gt_t_window"}


def _rows_with_a_key(S, T, causal, window):
    """(S,) bool: which query rows see at least one key."""
    i, j = np.arange(S)[:, None], np.arange(T)[None, :]
    vis = np.ones((S, T), bool)
    if causal:
        vis &= j <= i
    if window:
        vis &= j > i - window
    return vis.any(axis=1)


def _flash_inputs(B, Hq, Hkv, S, T, D, seed=0):
    """Head-major q (B, Hq, S, D), k/v (B, Hkv, T, D) as fp32 numpy."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Hq, S, D), np.float32),
            rng.standard_normal((B, Hkv, T, D), np.float32),
            rng.standard_normal((B, Hkv, T, D), np.float32))


def _flash_both(arrays, dtype, **kw):
    """(port output, Pallas kernel output in interpret mode, reference
    oracle output) as fp32 numpy, on the same inputs."""
    jdt, tdt, _ = DTYPES[dtype]
    jargs = [jnp.asarray(a, jdt) for a in arrays]
    targs = [torch.tensor(a).to(tdt) for a in arrays]
    before = flash_prefill.launches
    got = flash_prefill(*targs, **kw)
    assert flash_prefill.launches == before            # CPU: plain version
    assert got.dtype == tdt and got.shape == targs[0].shape
    np.testing.assert_array_equal(got.float().numpy(),
                                  ref_flash_prefill(*targs, **kw)
                                  .float().numpy())
    pallas = pallas_flash_prefill(*jargs, interpret=True, **kw)
    oracle = jax_ref_flash_prefill(*jargs, **kw)
    return (got.float().numpy(), np.asarray(pallas, np.float32),
            np.asarray(oracle, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_prefill_plain_matches_pallas(case, dtype):
    """The wrapper on CPU tensors against the Pallas kernel in interpret
    mode and the reference's oracle, every reference case, f32 and bf16."""
    B, Hq, Hkv, S, T, D, window, softcap = case
    tol = DTYPES[dtype][2]
    got, pallas, oracle = _flash_both(_flash_inputs(B, Hq, Hkv, S, T, D),
                                      dtype, window=window, softcap=softcap)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("edge", sorted(FLASH_EDGES))
def test_flash_prefill_edges_match_pallas(edge, dtype):
    """Shapes and masks the reference cases leave out, against the Pallas
    kernel in interpret mode: rows with no visible key (exactly 0 on both),
    causal=False with S != T, a window at or past T, a window of 1 (each
    query sees only its own key), S and T not powers of two, group 16 and
    head_dim 256."""
    B, Hq, Hkv, S, T, D, causal, window, softcap = FLASH_EDGES[edge]
    tol = DTYPES[dtype][2]
    arrays = _flash_inputs(B, Hq, Hkv, S, T, D, seed=1)
    got, pallas, oracle = _flash_both(arrays, dtype, causal=causal,
                                      window=window, softcap=softcap)
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    seen = _rows_with_a_key(S, T, causal, window)
    assert (not seen.all()) == (edge in FLASH_MASKED_ROWS)
    if edge == "no_visible_key":
        # query i sees keys j <= i, j > i - 8, j < 16: none for i >= 23
        assert seen.sum() == 23 and not seen[23:].any()
    # rows with no visible key: exactly 0 in the port and the Pallas
    # kernel, the oracle's mean(v) there; every other row as the oracle's
    assert not got[:, :, ~seen].any() and not pallas[:, :, ~seen].any()
    assert got[:, :, seen].all()
    if not seen.all():
        assert np.abs(oracle[:, :, ~seen]).max() > 0.1
    np.testing.assert_allclose(got[:, :, seen], oracle[:, :, seen],
                               atol=tol, rtol=tol)
    if edge == "window_1":
        v = torch.tensor(arrays[2]).to(DTYPES[dtype][1]).float().numpy()
        np.testing.assert_array_equal(got, np.repeat(v, Hq // Hkv, axis=1))


def test_flash_prefill_block_sizes_do_not_change_result():
    """test_flash_block_skipping_correct's case (S=512, window 128, 64-row
    blocks, so the Pallas kernel skips many key blocks whole): the port,
    given the same block sizes, matches it."""
    arrays = _flash_inputs(1, 2, 1, 512, 512, 64, seed=2)
    kw = dict(window=128, block_q=64, block_k=64)
    got = flash_prefill(*(torch.tensor(a) for a in arrays), **kw)
    pallas = pallas_flash_prefill(*(jnp.asarray(a) for a in arrays),
                                  interpret=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-5,
                               rtol=2e-5)
    np.testing.assert_array_equal(
        got.numpy(), flash_prefill(*(torch.tensor(a) for a in arrays),
                                   window=128).numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", [c for c in FLASH_CASES] + [
    FLASH_EDGES[e] for e in sorted(FLASH_EDGES)
    if e not in FLASH_MASKED_ROWS], ids=str)
def test_ref_flash_prefill_matches_reference_oracle(case, dtype):
    """The port's plain version against ``repro.kernels.ref``'s on every
    case in which each query row sees at least one key."""
    if len(case) == 8:
        B, Hq, Hkv, S, T, D, window, softcap = case
        causal = True
    else:
        B, Hq, Hkv, S, T, D, causal, window, softcap = case
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _flash_inputs(B, Hq, Hkv, S, T, D, seed=3)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = ref_flash_prefill(*(torch.tensor(a).to(tdt) for a in arrays), **kw)
    want = jax_ref_flash_prefill(*(jnp.asarray(a, jdt) for a in arrays), **kw)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_ref_flash_prefill_row_blocks_do_not_change_result(monkeypatch):
    """The plain version's blocks of query rows (which bound its scores'
    memory at full width) give the unblocked result bit for bit."""
    import repro_torch.kernels.ref as ref_mod
    arrays = [torch.tensor(a) for a in _flash_inputs(2, 4, 2, 75, 90, 32)]
    kw = dict(window=20, softcap=10.0)
    whole = ref_flash_prefill(*arrays, **kw)
    monkeypatch.setattr(ref_mod, "_FLASH_REF_BLOCK", 2 * 4 * 90 * 7)
    np.testing.assert_array_equal(ref_flash_prefill(*arrays, **kw).numpy(),
                                  whole.numpy())


#: narrow copies of the full-width dense shapes the card holds the bf16
#: kernel to ``MAIN_SHAPE_FLASH_BF16_TOL`` at: Llama-3.1-8B's heads (32/8,
#: D 128, causal) and Gemma-2-27B's (32/16, D 128, window, softcap 50), the
#: sequence cut to 256 and the window to 64. Gemma's queries are scaled by 8
#: (scores of std ~8) so that the cap bends the largest scores, as in
#: chip_smoke.py.
FLASH_TOL_SHAPES = {"llama": (32, 8, 256, 0, 0.0, 1.0),
                    "gemma": (32, 16, 256, 64, 50.0, 8.0)}


@pytest.mark.parametrize("shape,fault", [
    ("llama", "faithful"), ("llama", "one_key_too_far"),
    ("llama", "wrong_kv_head"),
    ("gemma", "faithful"), ("gemma", "window_one_too_wide"),
    ("gemma", "one_key_too_far"), ("gemma", "wrong_kv_head"),
    ("gemma", "softcap_skipped")])
def test_main_shape_flash_bf16_tolerance_separates_faults(shape, fault):
    """``MAIN_SHAPE_FLASH_BF16_TOL`` passes a result rounded through another
    path (fp64) and fails: the window one key too wide; the causal boundary
    one key too far (each query at the position after its own); the first
    query group reading the second kv head; the softcap skipped."""
    Hq, Hkv, S, window, softcap, qscale = FLASH_TOL_SHAPES[shape]
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.standard_normal((1, Hq, S, 128), np.float32)
                     * qscale).bfloat16()
    k, v = (torch.tensor(rng.standard_normal((1, Hkv, S, 128), np.float32))
            .bfloat16() for _ in range(2))
    kw = dict(window=window, softcap=softcap)
    want = ref_flash_prefill(q, k, v, **kw).float()
    if fault == "faithful":
        got = ref_flash_prefill(q.double(), k.double(), v.double(), **kw)
    elif fault == "window_one_too_wide":
        got = ref_flash_prefill(q, k, v, window=window + 1, softcap=softcap)
    elif fault == "one_key_too_far":
        shifted = torch.cat([torch.zeros_like(q[:, :, :1]), q], dim=2)
        got = ref_flash_prefill(shifted, k, v, **kw)[:, :, 1:]
    elif fault == "wrong_kv_head":
        k2, v2 = k.clone(), v.clone()
        k2[:, 0], v2[:, 0] = k[:, 1], v[:, 1]
        got = ref_flash_prefill(q, k2, v2, **kw)
    else:
        got = ref_flash_prefill(q, k, v, window=window)
    got = got.bfloat16().float()
    close = torch.allclose(got, want, **MAIN_SHAPE_FLASH_BF16_TOL)
    assert close == (fault == "faithful"), (fault, (got - want).abs().max())
