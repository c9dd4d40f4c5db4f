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
the reference's own head_dim 16 and at 32, eager and chunked. The layers of
the other archs (MoE, SSD, RG-LRU, sliding windows) and every ``ASSIGNED``
arch's engine at ``reduced()`` width run on the card against the CPU, the
MoE ones on the paged plane (granite-moe-3b-a800m's heads, a query group
of 3 at head_dim 64, are also in the kernel cases), the rest on the dense
fallback. Training (plain torch, no kernel): the flash backward, an Eq. 7
step and an AdamW update on the card against the CPU, and serving's
tokens beside a training step. Relay on a toy engine (a publish and a hit,
tokens equal to relay off and to the CPU), the serve launcher's local
engine on the card against ``--device cpu``, and the serving simulator at
Llama-3.1-8B width.
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
from repro_torch.params import tree_leaves, tree_map
from repro_torch.serving import LocalDisaggEngine, SamplingParams

pytestmark = pytest.mark.gpu

LLAMA_DECODE = (8, 32, 8, 128, 16, 256, 2049)
# the engine's own fused decode step at Llama-3.1-8B width: 2 models x 2
# rows, tables bucketed to 128 pages (serving/decode.py)
ENGINE_DECODE = (4, 32, 8, 128, 16, 128, 2049)
# chatglm3-6b's heads (src/repro/configs/chatglm3_6b.py: 32 query heads, 2
# kv heads, so a query group of 16, head_dim 128), page 16, up to 4k tokens
CHATGLM_DECODE = (4, 32, 2, 128, 16, 256, 1025)
# granite-moe-3b-a800m's heads (24 query heads over 8 kv heads, a query
# group of 3, head_dim 64) at the engine's fused decode step
GRANITE_DECODE = (4, 24, 8, 64, 16, 128, 2049)
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
    GRANITE_DECODE,                    # granite-moe-3b-a800m's heads
]
MAIN_DECODE = (LLAMA_DECODE, ENGINE_DECODE, CHATGLM_DECODE, GRANITE_DECODE)
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
# granite-moe-3b-a800m's heads (group 3, head_dim 64) at the same shapes
GRANITE_CHUNKS = [(1, 24, 8, 64, 16, 64, 2049, 200, 800),
                  (4, 24, 8, 64, 16, 128, 2049, 40, 992)]
MAIN_CHUNK_CASES = LLAMA_CHUNKS + CHATGLM_CHUNKS + GRANITE_CHUNKS
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
    (32, 1024, 8, 64, 16, 32 * 2049),      # granite-moe: 32 layers folded
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
    *GRANITE_CHUNKS,
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


# ======================================================================
# the host swap tier and preemption on the card


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_swap_pool_round_trip_on_card(card, dtype):
    """``HostSwapPool`` on a CUDA pool at Llama-3.1-8B's KV heads (8 of
    head_dim 128, page 16; a layer group and a tail layer): ``put`` lands
    the pages in pinned host tensors, ``restore`` of a subset into OTHER
    rows is bit-equal to what ``put`` read, sentinel row 0 stays zero, and
    every transfer's bytes and seconds reach ``observe``."""
    from repro_torch.kvcache.paged import PagedKVPool
    from repro_torch.kvcache.swap import HostSwapPool, _leaves
    cfg = ModelConfig(name="swap-card", arch_type="dense", n_layers=3,
                      d_model=256, n_heads=32, n_kv_heads=8, head_dim=128,
                      d_ff=512, vocab_size=64, dtype=dtype,
                      layer_pattern=(ATTN, ATTN))
    pool = PagedKVPool(cfg, 40, 16, device=card)
    g = torch.Generator(device=card).manual_seed(0)
    for _, _, a, _ in _leaves(pool.pool_state()):
        a.copy_(torch.randn(a.shape, generator=g, device=card))
        a.select(1 if a.dim() == 5 else 0, 0).zero_()
    src = [3, 9, 17, 4, 30]                       # 5 pages: bucket 8
    idx = torch.tensor(src, device=card)
    before = [a.index_select(axis, idx).cpu()
              for _, _, a, axis in _leaves(pool.pool_state())]
    seen = []
    host = HostSwapPool(observe=lambda b, s: seen.append((b, s)))
    nbytes = host.put(pool, 1, src)
    assert nbytes == 5 * pool.page_bytes
    for key in ("kg", "vg"):
        for h in host._entries[1]["host"][key].values():
            assert h.is_pinned() and h.device.type == "cpu"
    dst, pos = [5, 6, 7, 8], [4, 0, 2, 3]        # bucket 4, no pad; then 3
    host.restore(pool, 1, pos, dst)
    host.restore(pool, 1, [1, 3, 0], [31, 32, 33])
    sel = torch.tensor(pos)
    sel3 = torch.tensor([1, 3, 0])
    for (_, _, a, axis), b in zip(_leaves(pool.pool_state()), before):
        got = a.index_select(axis, torch.tensor(dst, device=card)).cpu()
        assert torch.equal(got, b.index_select(axis, sel))
        got = a.index_select(axis, torch.tensor([31, 32, 33],
                                                device=card)).cpu()
        assert torch.equal(got, b.index_select(axis, sel3))
        assert not a.select(axis, 0).any(), "row 0 written"
    assert [b for b, _ in seen] == [nbytes, 4 * pool.page_bytes,
                                    3 * pool.page_bytes]
    assert all(s > 0 for _, s in seen)
    host.pop(1)
    assert host.total_bytes == 0 and len(host) == 0


@pytest.mark.parametrize("mode", ["swap", "recompute"])
def test_preempting_toy_engine_on_card_matches_cpu(card, mode):
    """tests/test_preempt.py's contention fleet (18 pages of 8) armed with
    ``preempt=True, overcommit=2.0, sanitize=True`` in a forced mode: card
    tokens equal the CPU's and an unarmed run's, with the same counters."""
    cfg, cpu = _toy_weights("hd16")

    def fleet(dev, **kw):
        base = tree_map(lambda t: t.to(dev), cpu["base"])
        eng = LocalDisaggEngine(cfg, base, device=dev, num_pages=18,
                                page_size=8, chunked=True, **kw)
        eng.models.register("m", base)
        if eng.swap is not None:
            eng.swap.cfg.mode = mode
        lo = [eng.generate("m", [2 + i] * 9, SamplingParams(max_tokens=40),
                           priority=0) for i in range(2)]
        for _ in range(4):
            eng.step()
        hi = [eng.generate("m", [30 + i] * 17, SamplingParams(max_tokens=6),
                           priority=5) for i in range(2)]
        eng.run()
        keys = ("preemptions", "swap_out_pages", "swap_in_pages",
                "recompute_tokens", "swap_bytes")
        assert eng.block_pool.free_count == 18
        return ([h.result().tolist() for h in lo + hi],
                {k: eng.stats()[k] for k in keys})

    armed = dict(preempt=True, overcommit=2.0, sanitize=True)
    got, n_card = fleet(card, **armed)
    want, n_cpu = fleet("cpu", **armed)
    assert got == want == fleet(card)[0]
    assert n_card == n_cpu and n_card["preemptions"] >= 1


# ======================================================================
# every ASSIGNED arch: layers and engines, card against CPU (fp32)


def _reduced(name):
    from repro_torch.configs.base import get_config
    return get_config(name).reduced(vocab=64)


def _scaled(tree, f=16.0):
    """Output projections scaled by ``f``, in place: with seeded random
    weights a tied-embedding model otherwise answers with its last input
    token at every step."""
    from repro_torch.launch.main_path import scale_outputs
    scale_outputs(tree, f)
    return tree


def _layer_case(name, block):
    cfg = _reduced(name)
    params = init_params(cfg, 0, device="cpu")
    g = params["groups"]
    lp = next(v for v in g.values() if block in v)
    return cfg, tree_map(lambda t: t[0], lp)


@pytest.mark.parametrize("name,block", [
    ("granite-moe-3b-a800m", "moe"), ("mamba2-780m", "ssd"),
    ("recurrentgemma-2b", "rglru")])
@pytest.mark.parametrize("S", [1, 37, 128])
def test_layer_on_card_matches_cpu(card, name, block, S):
    """``moe_apply`` (capacity from S: drops at 37 and 128 tokens with the
    config's own capacity factor; within 2e-5), ``ssd_apply`` and
    ``rglru_apply`` (S = 1 is the decode step, S > 1 the chunked scan;
    within 1e-4), fp32 on the card against the CPU, from a carried
    state."""
    import dataclasses

    from repro_torch.models.moe import moe_apply
    from repro_torch.models.rglru import init_rglru_cache, rglru_apply
    from repro_torch.models.ssd import init_ssd_cache, ssd_apply
    cfg, lp = _layer_case(name, block)
    if block == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=1.25)
    x = torch.randn((2, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(S))
    outs = {}
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev), lp[block])
        xd = x.to(dev)
        if block == "moe":
            out, aux = moe_apply(p, xd, cfg)
            outs[dev] = [out, aux["dropped_frac"], aux["lb_loss"]]
        else:
            init = init_ssd_cache if block == "ssd" else init_rglru_cache
            cache = init(cfg, 2, torch.float32, dev)
            for t in tree_leaves(cache):
                t.copy_(torch.randn(t.shape,
                                    generator=torch.Generator().manual_seed(1)
                                    ).to(dev) * 0.1)
            fn = ssd_apply if block == "ssd" else rglru_apply
            out, new = fn(p, xd, cfg, cache=cache)
            outs[dev] = [out] + [new[k] for k in sorted(new)]
    # the scans' exps and cumulative sums round differently on the card:
    # the reference's own SSD tests' 1e-4 (tests/test_models_units.py)
    tol = 2e-5 if block == "moe" else 1e-4
    err = max(float((a.cpu() - b).abs().max())
              for a, b in zip(outs[card], outs["cpu"]))
    print(f"{name} {block} S={S}: max|card - cpu| {err:.3e} (tol {tol})")
    for a, b in zip(outs[card], outs["cpu"]):
        torch.testing.assert_close(a.cpu(), b, atol=tol, rtol=tol)


def _arch_engine_tokens(name, dev, cpu_params, **kw):
    cfg = _reduced(name)
    p = {m: tree_map(lambda t: t.to(dev), t) for m, t in cpu_params.items()}
    eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"], "m1": p["m1"]},
                            device=dev, num_pages=64, page_size=8,
                            capacity=128, **kw)
    rng = np.random.default_rng(0)
    ctx = [int(t) for t in rng.integers(4, 60, 29)]
    out = []
    for m in ("m0", "m1", "m0"):
        ctx = ctx + [int(t) for t in rng.integers(4, 60, 5)]
        toks = eng.generate(m, ctx, SamplingParams(max_tokens=6),
                            session=0).result().tolist()
        out.append(toks)
        ctx = ctx + toks
    return out, eng


@pytest.mark.parametrize("name", [
    "granite-moe-3b-a800m", "grok-1-314b", "mamba2-780m",
    "recurrentgemma-2b", "gemma2-27b", "seamless-m4t-medium",
    "internvl2-76b"])
def test_arch_engine_on_card_matches_cpu(card, name):
    """Each arch at ``reduced()`` width (vocab 64, fp32) through
    ``LocalDisaggEngine.generate`` on one growing session: the card's
    greedy tokens equal the CPU's. MoE archs serve on the paged plane
    (eager, and chunked through ``flash_prefill_paged``), the others on the
    dense fallback; a gemma2 context outgrows its 64-token window."""
    cfg = _reduced(name)
    cpu = {m: _scaled(init_params(cfg, s, device="cpu"))
           for m, s in (("base", 0), ("m0", 1), ("m1", 2))}
    want, eng = _arch_engine_tokens(name, "cpu", cpu)
    assert eng.paged == cfg.is_moe
    before = paged_decode_attention.launches
    got, eng = _arch_engine_tokens(name, card, cpu)
    assert got == want
    assert len({t for r in got for t in r}) > 1
    if cfg.is_moe:
        assert paged_decode_attention.launches > before
        kw = dict(chunked=True, chunk_size=7, token_budget=16)
        before = flash_prefill_paged.launches
        chunked, _ = _arch_engine_tokens(name, card, cpu, **kw)
        assert flash_prefill_paged.launches > before
        assert chunked == _arch_engine_tokens(name, "cpu", cpu, **kw)[0]


# ======================================================================
# training on the card: the flash backward, an Eq. 7 step, and serving
# beside it (fp32, TF32 off)


@pytest.mark.parametrize("window,softcap", [(0, None), (96, 30.0)])
def test_flash_attention_grads_on_card_match_cpu(card, window, softcap):
    """``_FlashAttention`` (plain torch on either device) at internlm2-1.8b's
    heads (16 over 8, head_dim 128), 256 tokens in 64 x 128 blocks, ragged
    slots: o, dq, dk, dv on the card equal the CPU's within rtol 1e-4 /
    atol 1e-4 (fp32, summed in another order)."""
    from repro_torch.models.attention import attention
    rng = np.random.default_rng(0)
    B, S, Hq, Hkv, D = 2, 256, 16, 8, 128
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    k, v = (rng.standard_normal((B, S, Hkv, D), np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, S, Hq, D), np.float32)
    pos = np.tile(np.arange(S, dtype=np.int32), (B, 1))
    k_pos = pos.copy()
    k_pos[1, -40:] = -1
    out = {}
    for dev in ("cpu", "cuda"):
        ts = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (q, k, v)]
        o = attention(*ts, torch.tensor(pos, device=dev),
                      torch.tensor(k_pos, device=dev), window=window,
                      softcap=softcap, force_flash=True, q_chunk=64,
                      kv_chunk=128)
        o.backward(torch.tensor(do, device=dev))
        out[dev] = [o.detach().cpu()] + [t.grad.cpu() for t in ts]
    for a, b in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_eq7_step_on_card_matches_cpu(card):
    """One Eq. 7 step at a reduced config (internlm2-1.8b's, 2 layers,
    d_model 256, share ratio 0.5 so the decoder's own cache stays in the
    graph): the loss within 1e-5 and every gradient leaf within rtol 1e-4
    / atol 1e-5, card against CPU; then one AdamW update from the same
    (CPU) gradients on each device, within 1e-6."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.prefillshare import cache_conditioned_loss
    from repro_torch.training import data as D
    from repro_torch.training.optim import AdamW, apply_updates
    cfg = get_config("internlm2-1.8b").reduced(vocab=64)
    base = init_params(cfg, 0, device="cpu")
    dec = init_params(cfg, 1, device="cpu")
    b = next(D.batches(0, D.TaskSpec("copy", prompt_len=10, n_symbols=8,
                                     vocab=64), 4, 1))
    arrays = (b.prompt, b.target_in, b.target_out, b.target_mask)
    res = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.detach().to(dev).requires_grad_(True), dec)
        loss, _ = cache_conditioned_loss(
            cfg, p, tree_map(lambda x: x.to(dev), base),
            *(torch.tensor(a, device=dev) for a in arrays), share_ratio=0.5)
        loss.backward()
        res[dev] = (loss.detach().cpu(), tree_map(lambda x: x.grad.cpu(), p))
    torch.testing.assert_close(res["cuda"][0], res["cpu"][0], rtol=1e-5,
                               atol=1e-5)
    for a, b_ in zip(tree_leaves(res["cuda"][1]), tree_leaves(res["cpu"][1])):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-5)
    stepped = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda x: x.to(dev), dec)
        g = tree_map(lambda x: x.to(dev), res["cpu"][1])
        opt = AdamW(1e-3, weight_decay=0.01)
        upd, _ = opt.update(g, opt.init(p), p)
        stepped[dev] = [x.cpu() for x in tree_leaves(apply_updates(p, upd))]
    for a, b_ in zip(stepped["cuda"], stepped["cpu"]):
        torch.testing.assert_close(a, b_, rtol=1e-6, atol=1e-6)


def test_serving_tokens_unchanged_beside_training_on_card(card):
    """A toy engine's greedy tokens on the card are the CPU's, before and
    after a training step ran on the card in the same process with grad
    mode on (the decoder's leaves requiring grad)."""
    from repro_torch.core.prefillshare import cache_conditioned_loss
    from repro_torch.training.optim import AdamW
    from repro_torch.training.trainer import Trainer
    cfg, cpu = _toy_weights("hd16")
    want = _toy_tokens(cfg, cpu, "cpu")[0]
    assert _toy_tokens(cfg, cpu, "cuda")[0] == want
    base = tree_map(lambda x: x.cuda(), cpu["base"])
    tr = Trainer(lambda p, **kw: cache_conditioned_loss(cfg, p, base, **kw),
                 AdamW(1e-3))
    rng = np.random.default_rng(0)
    batch = {"prompt": rng.integers(4, 60, (2, 8)),
             "target_in": rng.integers(4, 60, (2, 5)),
             "target_out": rng.integers(4, 60, (2, 5)),
             "target_mask": np.ones((2, 5), np.float32)}
    batch = {k: torch.tensor(v).cuda() for k, v in batch.items()}
    dec = tree_map(lambda x: x.cuda(), cpu["m0"])
    _, _, loss = tr.step(dec, tr.opt.init(dec), batch)
    assert torch.isfinite(loss) and torch.is_grad_enabled()
    assert _toy_tokens(cfg, cpu, "cuda")[0] == want


# ----------------------------------------------------------------------
# relay, the serve launcher and the simulator

#: tests/test_relay.py's chain prompt: 2 full pages of 8 and a 4-token tail
RELAY_PROMPT = list(range(4, 24))


def _relay_chain(cfg, base, dev, **engine_kw):
    """A request of model "a" (the base itself), then one of "b" (the base
    again) over the first prompt, the first decode input and the answer:
    with relay on, the follow-up's prefix lies in decode-written pages."""
    b = tree_map(lambda t: t.to(dev), base)
    eng = LocalDisaggEngine(cfg, b, device=dev, num_pages=64, page_size=8,
                            **engine_kw)
    eng.models.register("a", b)
    eng.models.register("b", b)
    a_out = eng.generate("a", RELAY_PROMPT,
                         SamplingParams(max_tokens=12)).result().tolist()
    b_out = eng.generate("b", RELAY_PROMPT + [2] + a_out,
                         SamplingParams(max_tokens=6)).result().tolist()
    assert eng.block_pool.active_count == 0
    return (a_out, b_out), eng.stats()


@pytest.mark.parametrize("chunked", [False, True], ids=["eager", "chunked"])
def test_relay_toy_engine_on_card_matches_cpu(card, chunked):
    """fp32 toy engine: relay=True tokens on the card == relay=False tokens
    on the card == relay=True tokens on the CPU; with relay on, a publish
    and a relay hit, with it off neither."""
    cfg, cpu = _toy_weights("hd16")
    kw = dict(chunked=True, chunk_size=5, token_budget=16) if chunked else {}
    got = {}
    for dev, relay in (("cuda", True), ("cuda", False), ("cpu", True)):
        got[dev, relay], s = _relay_chain(cfg, cpu["base"], dev, relay=relay,
                                          **kw)
        if relay:
            assert s["relay_publishes"] >= 1 and s["relay_hit_tokens"] > 0, s
        else:
            assert s["relay_publishes"] == 0 and s["relay_hit_tokens"] == 0, s
    assert got["cuda", True] == got["cuda", False] == got["cpu", True]


def test_serve_launcher_on_card_matches_cpu(card, capsys):
    """``launch.serve --engine local`` on its default device (the card)
    prints what ``--device cpu`` prints: the turns' tokens and hit ratio."""
    from repro_torch.launch import serve
    out = {}
    for extra in ([], ["--device", "cpu"]):
        serve.main(["--engine", "local", "--turns", "1", "--gen", "4",
                    *extra])
        out[len(extra)] = capsys.readouterr().out
    assert out[0] == out[2] and "hit_ratio=" in out[0]


def test_simulator_full_width_summary_completes(card):
    """The serving simulator at Llama-3.1-8B width on the H100's figures
    (one card a worker): every session of both modes completes."""
    from repro_torch.configs.base import get_config
    from repro_torch.serving import ServingConfig, Simulator, make_sessions
    cfg = get_config("llama31-8b")
    for mode in ("baseline", "prefillshare"):
        r = Simulator(cfg, ServingConfig(mode=mode, chips_per_worker=1,
                                         hbm_per_worker=80e9),
                      make_sessions("react", n_sessions=24, arrival_rate=4.0,
                                    seed=0)).run()
        assert r["sessions_done"] == 24, r
        assert np.isfinite(r["p95_e2e_s"]) and r["throughput_tok_s"] > 0


# ======================================================================
# CUDA graphs of the fused decode forward (serving/decode.py)


def _graph_engines(card, model, dtype, n_layers=2, **engine_kw):
    """``(cfg, graphed, eager)``: two engines over the same weights
    (``launch.main_path``'s base and two stacked decoders, cut to
    ``n_layers``), the second with its decode graphs switched off."""
    from repro_torch.core.lora import unstack_params
    from repro_torch.launch import main_path
    cfg, base, stacked = main_path.build_weights(model, n_layers, card, dtype)
    decs = dict(zip(main_path.DECODERS, unstack_params(stacked, 2)))
    engines = [LocalDisaggEngine(cfg, base, decs, device=card, num_pages=256,
                                 page_size=16, **engine_kw)
               for _ in range(2)]
    for g in engines[1].decode_plane.groups:
        g.graphed = False
    return cfg, engines[0], engines[1]


def _graph_rounds(eng, cfg, models=("m0", "m1"), seed=5, sampled=True):
    """Five requests over a 20-token shared context, greedy and (with
    ``sampled``) seeded sampled by turns, answering 40-88 tokens: the
    block tables grow from 2 to 8 pages of 16 (npages 2 -> 4 -> 8) and the
    batch bucket falls from 4 to 1 as requests finish. Returns the tokens
    and the paged_decode launches counted."""
    rng = np.random.default_rng(seed)
    ctx = [int(t) for t in rng.integers(4, cfg.vocab_size, 20)]
    launches = paged_decode_attention.launches
    with eng.shared_context(ctx) as sc:
        reqs = [sc.generate(models[i % len(models)],
                            [int(t) for t in rng.integers(4, 60, 3 + i)],
                            SamplingParams(max_tokens=40 + 12 * i,
                                           temperature=0.8 * (i % 2)
                                           * sampled,
                                           top_p=0.9, seed=100 + i))
                for i in range(5)]
        eng.run()
    return ([r.result().tolist() for r in reqs],
            paged_decode_attention.launches - launches)


def _pool_page0_zero(eng):
    kv = eng.kvpool
    return (all(not a[:, 0].any() for a in (*kv.k_groups.values(),
                                             *kv.v_groups.values()))
            and all(not a[0].any() for a in (*kv.k_tail, *kv.v_tail)))


@pytest.mark.parametrize("chunked", [False, True], ids=["eager", "chunked"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_decode_graph_tokens_equal_eager(card, dtype, chunked):
    """Llama-3.1-8B at full width, 2 layers (chip_smoke phases 4-6 and 8's
    shapes): greedy and seeded tokens replayed from graphs equal those of
    the same step run eagerly, across two npages buckets; every forward is
    captured once or replayed, and the launches counted stay one
    paged_decode a layer a forward."""
    from repro_torch.launch import main_path
    kw = main_path.CHUNKED if chunked else {}
    cfg, graphed, eager = _graph_engines(card, "llama31-8b", dtype, **kw)
    got, n_got = _graph_rounds(graphed, cfg)
    want, n_want = _graph_rounds(eager, cfg)
    assert got == want
    s, e = graphed.stats, eager.stats
    assert s.decode_graph_captures >= 3 and s.decode_graph_replays > 0
    assert s.decode_graph_captures + s.decode_graph_replays \
        == s.decode_dispatches
    assert e.decode_graph_captures == e.decode_graph_replays == 0
    assert n_got == cfg.n_layers * s.decode_dispatches
    assert n_want == cfg.n_layers * e.decode_dispatches
    assert _pool_page0_zero(graphed)


def test_decode_graph_replays_granite_moe_group(card):
    """A granite-moe-3b-a800m group (40 experts top-8; a query group of 3
    at head_dim 64) at full width, 2 layers: its decode replays, with the
    eager tokens."""
    cfg, graphed, eager = _graph_engines(card, "granite-moe-3b-a800m",
                                         "bfloat16")
    assert _graph_rounds(graphed, cfg)[0] == _graph_rounds(eager, cfg)[0]
    assert graphed.stats.decode_graph_replays > 0
    assert _pool_page0_zero(graphed)


def test_plane_rebuilt_by_churn_recaptures_on_card(card):
    """A model registered mid-run relayouts the plane: the new plane
    captures its own graphs, and the card's greedy tokens still equal the
    CPU's over both rounds."""
    cfg, cpu = _toy_weights("hd32")

    def serve(dev):
        p = {m: tree_map(lambda t: t.to(dev), t) for m, t in cpu.items()}
        eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"],
                                                 "m1": p["m1"]},
                                device=dev, num_pages=128, page_size=8)
        first = _graph_rounds(eng, cfg, sampled=False)[0]
        captured = eng.stats.decode_graph_captures
        eng.models.register("m2", p["base"])
        second = _graph_rounds(eng, cfg, ("m0", "m1", "m2"), seed=6,
                               sampled=False)[0]
        return first + second, eng, captured

    want = serve("cpu")[0]
    got, eng, captured = serve(card)
    assert got == want
    assert eng.stats.plane_rebuilds == 1
    assert 0 < captured < eng.stats.decode_graph_captures
    assert eng.decode_plane.graph_captures \
        == eng.stats.decode_graph_captures - captured
    assert eng.decode_plane.graph_replays > 0


def test_profiler_sees_the_replayed_kernels_by_name(card):
    """Under torch.profiler a replayed step's kernels keep their names and
    device times: ``paged_decode`` and the products, which the benchmark's
    roofline, idle and breakdown readers look up."""
    from torch.profiler import ProfilerActivity, profile
    cfg, eng, _ = _graph_engines(card, "llama31-8b", "bfloat16")
    rng = np.random.default_rng(1)
    for i in range(3):
        eng.generate(f"m{i % 2}", [int(t) for t in rng.integers(4, 60, 30)],
                     SamplingParams(max_tokens=64))
    for _ in range(4):
        eng.step()
    before = eng.stats.decode_graph_replays
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            eng.step()
        torch.cuda.synchronize()
    assert eng.stats.decode_graph_replays == before + 3
    dev = {e.key: e.device_time_total for e in prof.key_averages()
           if e.device_time_total > 0}
    assert any("paged_decode" in k for k in dev), sorted(dev)
    assert any("gemm" in k.lower() or "nvjet" in k for k in dev), sorted(dev)
