"""Hopper kernels against their plain versions, on the card.

Marked ``gpu``: run with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py`` on a machine with an H100 (the kernels build with
nvcc for sm_90a at first use). Elsewhere every test skips, decided inside a
fixture so that every pytest worker collects the same tests. Tolerances are
the reference kernel tests' (2e-5 fp32, 2e-2 bf16), except bf16 at the
Llama-3.1-8B (chip_smoke's and the engine's own) and chatglm3-6b decode and
chunk shapes, which are held to ``MAIN_SHAPE_BF16_TOL`` and
``MAIN_SHAPE_PREFILL_BF16_TOL``, and at the full-width dense shapes
(Llama-3.1-8B's and Gemma-2-27B's heads), held to
``MAIN_SHAPE_FLASH_BF16_TOL``; paged_write is exact. The toy engines run at
the reference's own head_dim 16 and at 32, eager and chunked.
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kernels.flash_prefill import flash_prefill
from repro_torch.kernels.flash_prefill_paged import flash_prefill_paged
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kernels.paged_write import paged_write
from repro_torch.kernels.ref import (MAIN_SHAPE_BF16_TOL,
                                     MAIN_SHAPE_FLASH_BF16_TOL,
                                     MAIN_SHAPE_PREFILL_BF16_TOL,
                                     ref_flash_prefill, ref_paged_decode,
                                     ref_paged_prefill, ref_paged_write)
from repro_torch.models import init_params
from repro_torch.params import tree_map
from repro_torch.serving import LocalDisaggEngine, SamplingParams

pytestmark = pytest.mark.gpu

LLAMA_DECODE = (8, 32, 8, 128, 16, 256, 2049)
# the engine's own fused decode step at Llama-3.1-8B width: 2 models x 2
# rows, tables bucketed to 128 pages (serving/decode.py)
ENGINE_DECODE = (4, 32, 8, 128, 16, 128, 2049)
# chatglm3-6b's heads (src/repro/configs/chatglm3_6b.py: 32 query heads, 2
# kv heads, so a query group of 16, head_dim 128), page 16, up to 4k tokens
CHATGLM_DECODE = (4, 32, 2, 128, 16, 256, 1025)
PAGED_CASES = [
    # B, Hq, Hkv, D, page, npages, pool
    (3, 8, 2, 64, 16, 8, 40),
    (1, 4, 4, 128, 32, 4, 16),
    (2, 8, 1, 64, 16, 16, 64),
    (4, 2, 2, 32, 8, 4, 20),
    (5, 16, 2, 128, 128, 3, 9),        # pages longer than a 128-token tile
    (4, 2, 1, 16, 8, 4, 20),           # head_dim 16 (the toy configs)
    (2, 16, 1, 256, 16, 4, 12),        # group 16 at head_dim 256
    LLAMA_DECODE,                      # Llama-3.1-8B decode shape
    ENGINE_DECODE,                     # the engine's decode step
    CHATGLM_DECODE,                    # chatglm3-6b's heads
]
MAIN_DECODE = (LLAMA_DECODE, ENGINE_DECODE, CHATGLM_DECODE)
# B, Hq, Hkv, D, page, npages, pool, S, start (None: random); the chunked
# main path's chunk forwards, each table as wide as the scheduler buckets it
# (next power of two of the pages in use): the shared context's 200-token
# chunks, then the four tails of turn 1 (40 tokens) and turn 2 (72)
LLAMA_CHUNKS = [(1, 32, 8, 128, 16, 16, 2049, 200, 0),
                (1, 32, 8, 128, 16, 32, 2049, 200, 200),
                (1, 32, 8, 128, 16, 64, 2049, 200, 800),
                (4, 32, 8, 128, 16, 128, 2049, 40, 992),
                (4, 32, 8, 128, 16, 128, 2049, 72, 992),
                # one request's tail alone (profile.py's traced chunk)
                (1, 32, 8, 128, 16, 128, 2049, 40, 992)]
# chatglm3-6b's heads (group 16) at the same chunk shapes
CHATGLM_CHUNKS = [(1, 32, 2, 128, 16, 64, 1025, 200, 800),
                  (4, 32, 2, 128, 16, 128, 1025, 40, 992)]
MAIN_CHUNK_CASES = LLAMA_CHUNKS + CHATGLM_CHUNKS
PREFILL_CASES = [
    (2, 4, 2, 64, 8, 4, 16, 5, None),      # tests/test_kernels.py cases
    (1, 8, 1, 32, 16, 3, 8, 16, None),
    (3, 2, 2, 64, 8, 6, 32, 7, None),
    (1, 4, 2, 128, 16, 2, 8, 1, None),
    (2, 4, 2, 64, 8, 4, 12, 6, None),      # the reference's softcap case
    (3, 2, 1, 16, 8, 6, 24, 11, None),     # head_dim 16 (the toy configs)
    (2, 16, 2, 128, 16, 16, 64, 37, None),  # group 8, many row/key tiles
    (2, 4, 1, 32, 16, 16, 64, 130, 0),     # start 0, S > one key tile
    (2, 16, 1, 256, 16, 8, 24, 37, None),  # group 16 at head_dim 256
    (2, 8, 2, 64, 8, 12, 40, 70, None),    # head_dim 64, page 8
    *MAIN_CHUNK_CASES,                      # the chunked main path's shapes
]
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_decode_kernel_matches_plain(card, case, dtype, softcap):
    B, Hq, Hkv, D, page, npages, P = case
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, Hq, D), generator=g, device=card).to(dtype)
    kp = torch.randn((P, page, Hkv, D), generator=g, device=card).to(dtype)
    vp = torch.randn((P, page, Hkv, D), generator=g, device=card).to(dtype)
    bt = torch.randint(0, P, (B, npages), generator=g, device=card,
                       dtype=torch.int32)
    ln = torch.randint(1, page * npages + 1, (B,), generator=g, device=card,
                       dtype=torch.int32)
    before = paged_decode_attention.launches
    got = paged_decode_attention(q, kp, vp, bt, ln, softcap=softcap)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = ref_paged_decode(q, kp, vp, bt, ln, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(),
                               **_decode_tol(case, dtype))


def _decode_inputs(card, case, dtype, lengths=None, seed=0):
    """Random q and pools; tables of distinct pages with sentinel page 0
    past each sequence's last page (the engine's layout); lengths random
    in 1..npages * page unless given."""
    B, Hq, Hkv, D, page, npages, P = case
    g = torch.Generator(device=card).manual_seed(seed)
    q = torch.randn((B, Hq, D), generator=g, device=card).to(dtype)
    kp = torch.randn((P, page, Hkv, D), generator=g, device=card).to(dtype)
    vp = torch.randn((P, page, Hkv, D), generator=g, device=card).to(dtype)
    rng = np.random.default_rng(seed)
    ln = (rng.integers(1, page * npages + 1, B) if lengths is None
          else np.asarray(lengths))
    bt = np.zeros((B, npages), np.int64)
    for b in range(B):
        live = -(-int(ln[b]) // page)
        bt[b, :live] = rng.choice(np.arange(1, P), live, replace=live > P - 1)
    return (q, kp, vp, torch.tensor(bt, dtype=torch.int32, device=card),
            torch.tensor(ln, dtype=torch.int32, device=card))


def _decode_tol(case, dtype):
    if case in MAIN_DECODE and dtype == torch.bfloat16:
        return MAIN_SHAPE_BF16_TOL
    return {"atol": TOL[dtype], "rtol": TOL[dtype]}


@pytest.mark.parametrize("splits", [2, 3, 7])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("case", [c for c in PAGED_CASES if c[3] >= 64],
                         ids=str)
def test_paged_decode_split_matches_unsplit(card, case, softcap, splits):
    """The bf16 tensor-core kernel with each sequence's keys split into 2, 3
    or 7 parts and merged, against the same kernel unsplit and against the
    plain version (one launch counted per call either way). Random lengths
    from 1 up leave some parts without a key."""
    args = _decode_inputs(card, case, torch.bfloat16)
    whole = paged_decode_attention(*args, softcap=softcap, splits=1)
    before = paged_decode_attention.launches
    got = paged_decode_attention(*args, softcap=softcap, splits=splits)
    torch.cuda.synchronize()
    assert paged_decode_attention.launches == before + 1
    want = ref_paged_decode(*args, softcap=softcap)
    tol = _decode_tol(case, torch.bfloat16)
    torch.testing.assert_close(got.float(), whole.float(), **tol)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("dtype,splits", [
    (torch.float32, None), (torch.bfloat16, None), (torch.bfloat16, 1),
    (torch.bfloat16, 3)], ids=str)
def test_paged_decode_ragged_batch_with_padding_rows(card, dtype, splits):
    """The fused grid's ragged batch at the engine's width: real rows of
    1032-1100 tokens beside padding rows (length 1, a table of zeros, so
    they attend over sentinel page 0 alone). Every row matches the plain
    version; a padding row's output is sentinel page 0's first V row."""
    B, Hq, Hkv, D, page, npages, P = ENGINE_DECODE
    ln = [1071, 1, 1100, 1032, 1, 1, 1057, 1]
    q, kp, vp, bt, lengths = _decode_inputs(
        card, (len(ln), Hq, Hkv, D, page, npages, P), dtype, ln, seed=4)
    pad = torch.tensor([n == 1 for n in ln], device=card)
    bt[pad] = 0
    got = paged_decode_attention(q, kp, vp, bt, lengths, splits=splits)
    want = ref_paged_decode(q, kp, vp, bt, lengths)
    torch.cuda.synchronize()
    tol = (MAIN_SHAPE_BF16_TOL if dtype == torch.bfloat16
           else {"atol": 2e-5, "rtol": 2e-5})
    torch.testing.assert_close(got.float(), want.float(), **tol)
    v0 = vp[0, 0].repeat_interleave(Hq // Hkv, dim=0)         # (Hq, D)
    for b in torch.nonzero(pad).flatten().tolist():
        torch.testing.assert_close(got[b].float(), v0.float(), **tol)


def test_paged_decode_counts_one_launch_per_call(card):
    """One count per call on the card, whether or not the parts are merged;
    none on the CPU, where the plain version runs."""
    args = _decode_inputs(card, ENGINE_DECODE, torch.bfloat16)
    cpu = tuple(a.cpu() for a in args)
    before = paged_decode_attention.launches
    paged_decode_attention(*cpu)
    assert paged_decode_attention.launches == before
    for n in (None, 1, 5):
        paged_decode_attention(*args, splits=n)
        torch.cuda.synchronize()
        before += 1
        assert paged_decode_attention.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", [
    # B, S, Hkv, D, page, pool
    (3, 64, 2, 32, 16, 24),
    (1, 32, 4, 64, 8, 12),
    (2, 128, 1, 128, 32, 16),
    (32, 1024, 8, 128, 16, 32 * 2049),     # Llama: 32 layers folded
], ids=str)
def test_paged_write_kernel_bitwise(card, case, dtype):
    B, S, H, D, page, P = case
    npages = S // page
    g = torch.Generator(device=card).manual_seed(1)
    nk = torch.randn((B, S, H, D), generator=g, device=card).to(dtype)
    nv = torch.randn((B, S, H, D), generator=g, device=card).to(dtype)
    kp = torch.randn((P, page, H, D), generator=g, device=card).to(dtype)
    vp = torch.randn((P, page, H, D), generator=g, device=card).to(dtype)
    rng = np.random.default_rng(2)
    bt = rng.permutation(P)[:B * npages].reshape(B, npages).astype(np.int32)
    nvalid = rng.integers(1, npages + 1, B).astype(np.int32)
    want_k, want_v = ref_paged_write(nk, nv, kp.clone(), vp.clone(), bt,
                                     nvalid)
    paged_write(nk, nv, kp, vp, bt, nvalid)
    torch.cuda.synchronize()
    assert torch.equal(kp, want_k) and torch.equal(vp, want_v)


def _prefill_inputs(card, case, dtype):
    B, Hq, Hkv, D, page, npages, P, S, st0 = case
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, S, Hq, D), generator=g, device=card).to(dtype)
    kp = torch.randn((P, page, Hkv, D), generator=g, device=card).to(dtype)
    vp = torch.randn((P, page, Hkv, D), generator=g, device=card).to(dtype)
    rng = np.random.default_rng(1)
    if st0 is None:
        bt = rng.integers(0, P, (B, npages))
        st = rng.integers(0, npages * page - S + 1, B)
    else:                   # the engine's layout: sentinel 0 past the end
        live = -(-(st0 + S) // page)
        bt = np.zeros((B, npages), np.int64)
        bt[:, :live] = rng.permutation(np.arange(1, P))[:B * live].reshape(
            B, live)
        st = np.full(B, st0)
    bt = torch.tensor(bt, dtype=torch.int32, device=card)
    st = torch.tensor(st, dtype=torch.int32, device=card)
    return q, kp, vp, bt, st


def _prefill_tol(case, dtype):
    if case in MAIN_CHUNK_CASES and dtype == torch.bfloat16:
        return MAIN_SHAPE_PREFILL_BF16_TOL
    return {"atol": TOL[dtype], "rtol": TOL[dtype]}


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", PREFILL_CASES, ids=str)
def test_flash_prefill_paged_kernel_matches_plain(card, case, dtype, softcap):
    args = _prefill_inputs(card, case, dtype)
    before = flash_prefill_paged.launches
    got = flash_prefill_paged(*args, softcap=softcap)
    torch.cuda.synchronize()
    assert flash_prefill_paged.launches == before + 1
    want = ref_paged_prefill(*args, softcap=softcap)
    torch.testing.assert_close(got.float(), want.float(),
                               **_prefill_tol(case, dtype))


@pytest.mark.parametrize("splits", [2, 3, 7])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("case", [
    (2, 4, 2, 64, 8, 4, 16, 5, None),      # fewer key tiles than parts
    (2, 16, 1, 256, 16, 8, 24, 37, None),  # group 16 at head_dim 256
    (2, 16, 2, 128, 16, 16, 64, 37, None),
    (1, 32, 8, 128, 16, 64, 2049, 200, 800),
    (4, 32, 8, 128, 16, 128, 2049, 40, 992),
], ids=str)
def test_flash_prefill_paged_split_matches_unsplit(card, case, softcap,
                                                   splits):
    """The bf16 tensor-core kernel with each row tile's keys split into 2, 3
    or 7 parts and merged, against the same kernel unsplit and against the
    plain version (one launch counted per call either way)."""
    args = _prefill_inputs(card, case, torch.bfloat16)
    whole = flash_prefill_paged(*args, softcap=softcap, splits=1)
    before = flash_prefill_paged.launches
    got = flash_prefill_paged(*args, softcap=softcap, splits=splits)
    torch.cuda.synchronize()
    assert flash_prefill_paged.launches == before + 1
    want = ref_paged_prefill(*args, softcap=softcap)
    tol = _prefill_tol(case, torch.bfloat16)
    torch.testing.assert_close(got.float(), whole.float(), **tol)
    torch.testing.assert_close(got.float(), want.float(), **tol)


# B, Hq, Hkv, S, T, D, causal, window, softcap
FLASH_CASES = [
    (2, 4, 2, 128, 128, 64, True, 0, 0.0),     # tests/test_kernels.py cases
    (1, 8, 8, 256, 256, 128, True, 0, 0.0),
    (1, 8, 1, 192, 192, 64, True, 0, 0.0),
    (2, 4, 2, 128, 128, 64, True, 64, 0.0),
    (1, 4, 2, 256, 256, 128, True, 0, 50.0),
    (1, 2, 1, 64, 320, 64, True, 0, 0.0),
    (1, 4, 4, 96, 96, 32, True, 32, 30.0),
    (1, 2, 1, 64, 16, 64, True, 8, 0.0),       # rows 23.. see no key
    (2, 4, 2, 48, 80, 32, False, 0, 0.0),      # the CPU tests' edges
    (1, 4, 2, 80, 48, 32, False, 16, 0.0),     # rows 63.. see no key
    (1, 4, 2, 64, 64, 32, True, 100, 0.0),
    (1, 4, 1, 40, 40, 32, True, 1, 0.0),
    (1, 4, 2, 97, 100, 64, True, 0, 0.0),
    (1, 4, 2, 97, 100, 64, True, 16, 20.0),
    (1, 16, 1, 64, 64, 32, True, 0, 0.0),
    (1, 2, 1, 32, 32, 256, True, 0, 0.0),
    (2, 10, 1, 1000, 1000, 256, True, 0, 0.0),  # MQA group 10, S=1000
]
# B, Hq, Hkv, S, T, D, window, softcap, query scale: the full-width shapes
# in the model's layout (chip_smoke.FLASH_MAIN): Llama-3.1-8B's heads at
# 1000 and 8192 tokens, Gemma-2-27B's at 8192 with its window and softcap
FLASH_MAIN = {"llama_1000": (1, 32, 8, 1000, 1000, 128, 0, 0.0, 1.0),
              "llama_8192": (1, 32, 8, 8192, 8192, 128, 0, 0.0, 1.0),
              "gemma2_27b_8192": (1, 32, 16, 8192, 8192, 128, 4096, 50.0,
                                  8.0)}


def _no_key_rows(S, T, causal, window, device):
    i = torch.arange(S, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    vis = torch.ones((S, T), dtype=torch.bool, device=device)
    if causal:
        vis &= j <= i
    if window:
        vis &= j > i - window
    return ~vis.any(dim=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("case", FLASH_CASES, ids=str)
def test_flash_prefill_kernel_matches_plain(card, case, dtype):
    B, Hq, Hkv, S, T, D, causal, window, softcap = case
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn((B, Hq, S, D), generator=g, device=card).to(dtype)
    k = torch.randn((B, Hkv, T, D), generator=g, device=card).to(dtype)
    v = torch.randn((B, Hkv, T, D), generator=g, device=card).to(dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = flash_prefill.launches
    got = flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert flash_prefill.launches == before + 1
    want = ref_flash_prefill(q, k, v, **kw)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    blind = _no_key_rows(S, T, causal, window, card)
    assert not got[:, :, blind].any()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=str)
@pytest.mark.parametrize("shape", sorted(FLASH_MAIN))
def test_flash_attention_full_width_matches_plain(card, shape, dtype):
    """Through ``kernels.flash_attention`` in the model's layout; bf16 held
    to ``MAIN_SHAPE_FLASH_BF16_TOL``, fp32 to 2e-5."""
    B, Hq, Hkv, S, T, D, window, softcap, qscale = FLASH_MAIN[shape]
    g = torch.Generator(device=card).manual_seed(1)
    q = (torch.randn((B, S, Hq, D), generator=g, device=card)
         * qscale).to(dtype)
    k = torch.randn((B, T, Hkv, D), generator=g, device=card).to(dtype)
    v = torch.randn((B, T, Hkv, D), generator=g, device=card).to(dtype)
    kw = dict(window=window, softcap=softcap)
    got = kernels.flash_attention(q, k, v, **kw)
    want = ref_flash_prefill(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), **kw).transpose(1, 2)
    tol = MAIN_SHAPE_FLASH_BF16_TOL if dtype == torch.bfloat16 else {
        "atol": 2e-5, "rtol": 2e-5}
    torch.testing.assert_close(got.float(), want.float(), **tol)


def test_flash_attention_reads_strided_views_in_place(card):
    """Non-contiguous seq-major views (q, k, v cut from one packed qkv
    projection, as a fused projection would give them) run without a copy
    and give the same bits as contiguous copies; a row that is not 16-byte
    aligned is refused."""
    B, S, Hq, Hkv, D = 2, 150, 8, 2, 64
    g = torch.Generator(device=card).manual_seed(2)
    for dtype in (torch.float32, torch.bfloat16):
        qkv = torch.randn((B, S, Hq + 2 * Hkv, D), generator=g,
                          device=card).to(dtype)
        q, k, v = qkv.split([Hq, Hkv, Hkv], dim=2)
        assert not q.is_contiguous() and not k.is_contiguous()
        kw = dict(window=40, softcap=20.0)
        got = kernels.flash_attention(q, k, v, **kw)
        want = kernels.flash_attention(q.contiguous(), k.contiguous(),
                                       v.contiguous(), **kw)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, want)
        head_major = flash_prefill(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw)
        assert torch.equal(head_major.transpose(1, 2), want)
    wide = torch.randn((B, S, Hq, D + 1), device=card)
    with pytest.raises(ValueError, match="16-byte"):
        kernels.flash_attention(wide[..., 1:], k.float(), v.float())


TOY_CFGS = {
    # the reference's toy config (tests/test_paged_engine.py): head_dim 16
    "hd16": dict(name="paged-eng", arch_type="dense", n_layers=2, d_model=32,
                 n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
                 dtype="float32"),
    "hd32": dict(name="toy", arch_type="dense", n_layers=3, d_model=64,
                 n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
                 vocab_size=64, dtype="float32", layer_pattern=(ATTN, ATTN)),
}


def _toy_tokens(cfg, cpu, dev, **engine_kw):
    p = {m: tree_map(lambda t: t.to(dev), t) for m, t in cpu.items()}
    eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"], "m1": p["m1"]},
                            device=dev, num_pages=64, page_size=8,
                            **engine_kw)
    with eng.shared_context(list(range(4, 27))) as ctx:
        reqs = [ctx.generate(m, [5, 6, 7 + i], SamplingParams(max_tokens=6))
                for i, m in enumerate(("m0", "m1", "m0"))]
        return [r.result().tolist() for r in reqs], eng


def _toy_weights(name):
    cfg = ModelConfig(**TOY_CFGS[name])
    return cfg, {m: init_params(cfg, s, device="cpu")
                 for m, s in (("base", 0), ("m0", 1), ("m1", 2))}


@pytest.mark.parametrize("name", sorted(TOY_CFGS))
def test_toy_engine_on_card_matches_cpu(card, name):
    """The same toy engine, same weights: card (kernels) and CPU (plain
    versions) give identical greedy tokens."""
    cfg, cpu = _toy_weights(name)
    outs = {dev: _toy_tokens(cfg, cpu, dev)[0] for dev in ("cpu", "cuda")}
    assert outs["cuda"] == outs["cpu"]


@pytest.mark.parametrize("chunk", [3, 8])
@pytest.mark.parametrize("name", sorted(TOY_CFGS))
def test_chunked_toy_engine_on_card_matches_cpu(card, name, chunk):
    """Chunked prefill (boundaries mid-page) through flash_prefill_paged:
    card tokens equal the CPU's chunked tokens and the card's eager ones."""
    cfg, cpu = _toy_weights(name)
    eager = _toy_tokens(cfg, cpu, "cuda")[0]
    kw = dict(chunked=True, chunk_size=chunk, token_budget=16)
    cpu_out = _toy_tokens(cfg, cpu, "cpu", **kw)[0]
    before = flash_prefill_paged.launches
    card_out, eng = _toy_tokens(cfg, cpu, "cuda", **kw)
    assert flash_prefill_paged.launches > before
    assert eng.scheduler.stats.chunks > 1
    assert card_out == cpu_out == eager


def test_ragged_fused_batch_leaves_sentinel_row_zero_on_card(card):
    """Two m0 rows and one m1 row: the fused grid has a padding row, which
    must write nothing into pool row 0."""
    cfg, cpu = _toy_weights("hd16")
    p = {m: tree_map(lambda t: t.to(card), t) for m, t in cpu.items()}
    eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"], "m1": p["m1"]},
                            device=card, num_pages=64, page_size=8)
    rng = np.random.default_rng(3)
    for n, m in ((37, "m0"), (9, "m0"), (20, "m1")):
        eng.generate(m, list(rng.integers(4, 60, size=n)),
                     SamplingParams(max_tokens=5))
    eng.run()
    kv = eng.kvpool
    for a in (*kv.k_groups.values(), *kv.v_groups.values()):
        assert not a[:, 0].any()
    for a in (*kv.k_tail, *kv.v_tail):
        assert not a[0].any()


# ======================================================================
# sampling and LoRA groups on the card


@pytest.mark.parametrize("V", [32000, 128256])
def test_sampler_on_card_matches_cpu(card, V):
    """The sampler on card-made logits against the same sampler on the CPU:
    keys, random bits and uniforms exact; tokens equal except rows whose two
    largest perturbed scores (the CPU's) differ by less than
    1e-5 * max(1, |score|), at most 1% of the rows."""
    from repro_torch.serving import sampling as S
    g = torch.Generator(device=card).manual_seed(5)
    N = 64
    logits = torch.randn((N, V), generator=g, device=card) * 3
    cpu = torch.Generator().manual_seed(6)
    seeds = torch.randint(-2**31, 2**31 - 1, (N,), generator=cpu,
                          dtype=torch.int64).to(torch.int32)
    pos = torch.randint(0, 4096, (N,), generator=cpu).to(torch.int32)
    temp = torch.tensor([0.0, 0.7, 1.5, 1.0] * (N // 4))
    top_k = torch.tensor([0, 1, 5, 50] * (N // 4)).roll(1)
    top_p = torch.tensor([1.0, 0.9, 0.5, 0.95] * (N // 4)).roll(2)
    args = (temp, top_k, top_p)
    keys_c = S.fold_keys(seeds, pos)
    keys_g = S.fold_keys(seeds.to(card), pos.to(card))
    assert torch.equal(keys_g.cpu(), keys_c)
    assert torch.equal(S.random_bits(keys_g, V).cpu(),
                       S.random_bits(keys_c, V))
    assert torch.equal(S.uniform(keys_g, V).cpu(), S.uniform(keys_c, V))
    got = S.sample_step(logits, pos.to(card), *(a.to(card) for a in args),
                        seeds.to(card)).cpu()
    lc = logits.cpu()
    want = S.sample_step(lc, pos, *args, seeds)
    bad = (got != want).nonzero()[:, 0]
    assert not (temp[bad] <= 0).any()          # greedy rows are exact
    if len(bad):
        score = (S.gumbel(keys_c[bad], V)
                 + S.filter_logits(lc[bad], *(a[bad] for a in args)))
        top2 = score.topk(2, -1).values
        gap = top2[:, 0] - top2[:, 1]
        assert (gap < 1e-5 * top2[:, 0].abs().clamp(min=1.0)).all(), gap
    assert len(bad) <= 0.01 * N


def _toy_lora(base, n, seed):
    from repro_torch.core.lora import LoRAPair, lora_init
    from repro_torch.serving import LoRAAdapter
    g = torch.Generator().manual_seed(seed)
    ads = {}
    for i in range(n):
        tree = lora_init(base, rank=4, generator=g)
        ads[f"l{i}"] = LoRAAdapter(_nonzero_b(tree, g, LoRAPair), alpha=8.0,
                                   rank=4)
    return ads


def _nonzero_b(node, g, pair):
    if isinstance(node, pair):
        return pair(node.A, 0.05 * torch.randn(node.B.shape, generator=g))
    if isinstance(node, dict):
        return {k: _nonzero_b(v, g, pair) for k, v in node.items()}
    if isinstance(node, list):
        return [_nonzero_b(v, g, pair) for v in node]
    return node


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TOY_CFGS))
def test_lora_group_on_card_identical_to_materialized(card, name, dtype):
    """Three LoRA decode models in one fused group on the card give the
    tokens of their ``lora_apply`` decoders on an all-full plane and of the
    per-model path, greedy and seeded."""
    from repro_torch.core.lora import lora_apply
    from repro_torch.serving import DecodeModelSpec
    cfg = ModelConfig(**{**TOY_CFGS[name], "dtype": dtype})
    tdt = getattr(torch, dtype)
    base = init_params(cfg, 0, device="cpu")
    ads = _toy_lora(base, 3, 9)
    on = lambda t: tree_map(lambda x: x.to(card, tdt), t)   # noqa: E731
    base = on(base)
    outs = {}
    for mode in ("lora", "full", "per-model"):
        eng = LocalDisaggEngine(cfg, base, device=card, num_pages=64,
                                page_size=8, fused=mode != "per-model")
        for mid, ad in ads.items():
            ad = type(ad)(on(ad.params), alpha=ad.alpha, rank=ad.rank)
            eng.models.register(mid, DecodeModelSpec(full=lora_apply(
                base, ad.params, alpha=8.0, rank=4)) if mode == "full"
                else DecodeModelSpec(lora=ad))
        with eng.shared_context(list(range(4, 27))) as ctx:
            reqs = [ctx.generate(m, [5, 6, 7 + i], SamplingParams(
                max_tokens=6, temperature=0.8 * (i % 2), seed=i))
                for i, m in enumerate(("l0", "l1", "l2", "l0"))]
            outs[mode] = [r.result().tolist() for r in reqs]
    assert outs["lora"] == outs["full"] == outs["per-model"]
