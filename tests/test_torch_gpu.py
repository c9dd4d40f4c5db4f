"""Hopper kernels against their plain versions, on the card.

Marked ``gpu``: run with ``PYTHONPATH=src python -m pytest -m gpu
tests/test_torch_gpu.py`` on a machine with an H100 (the kernels build with
nvcc for sm_90a at first use). Elsewhere every test skips, decided inside a
fixture so that every pytest worker collects the same tests. Tolerances are
the reference kernel tests' (2e-5 fp32, 2e-2 bf16), except bf16 at the
Llama-3.1-8B decode shape, which is held to ``MAIN_SHAPE_BF16_TOL``;
paged_write is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kernels.paged_write import paged_write
from repro_torch.kernels.ref import (MAIN_SHAPE_BF16_TOL, ref_paged_decode,
                                     ref_paged_write)
from repro_torch.models import init_params
from repro_torch.params import tree_map
from repro_torch.serving import LocalDisaggEngine, SamplingParams

pytestmark = pytest.mark.gpu

LLAMA_DECODE = (8, 32, 8, 128, 16, 256, 2049)
PAGED_CASES = [
    # B, Hq, Hkv, D, page, npages, pool
    (3, 8, 2, 64, 16, 8, 40),
    (1, 4, 4, 128, 32, 4, 16),
    (2, 8, 1, 64, 16, 16, 64),
    (4, 2, 2, 32, 8, 4, 20),
    (5, 16, 2, 128, 128, 3, 9),        # pages longer than a 128-token tile
    LLAMA_DECODE,                      # Llama-3.1-8B decode shape
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
    tol = {"atol": TOL[dtype], "rtol": TOL[dtype]}
    if case == LLAMA_DECODE and dtype == torch.bfloat16:
        tol = MAIN_SHAPE_BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), **tol)


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


def test_toy_engine_on_card_matches_cpu(card):
    """The same toy engine, same weights: card (kernels) and CPU (plain
    versions) give identical greedy tokens."""
    cfg = ModelConfig(name="toy", arch_type="dense", n_layers=3, d_model=64,
                      n_heads=4, n_kv_heads=2, head_dim=32, d_ff=128,
                      vocab_size=64, dtype="float32",
                      layer_pattern=(ATTN, ATTN))
    cpu = {m: init_params(cfg, s, device="cpu")
           for m, s in (("base", 0), ("m0", 1), ("m1", 2))}
    outs = {}
    for dev in ("cpu", "cuda"):
        p = {m: tree_map(lambda t: t.to(dev), t) for m, t in cpu.items()}
        eng = LocalDisaggEngine(cfg, p["base"], {"m0": p["m0"], "m1": p["m1"]},
                                device=dev, num_pages=64, page_size=8)
        with eng.shared_context(list(range(4, 27))) as ctx:
            reqs = [ctx.generate(m, [5, 6, 7 + i], SamplingParams(max_tokens=6))
                    for i, m in enumerate(("m0", "m1", "m0"))]
            outs[dev] = [r.result().tolist() for r in reqs]
    assert outs["cuda"] == outs["cpu"]
