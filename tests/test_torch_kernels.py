"""The port's kernel plain versions against the reference's kernels.

Inputs come from a numpy seed and reach both packages as numpy arrays. The
reference's Pallas kernels run in interpret mode, as tests/test_kernels.py
runs them; the port's wrappers, given CPU tensors, run their plain PyTorch
versions (the Hopper kernels are held against those on the card by
tests/test_torch_gpu.py and chip_smoke.py). Tolerances are the reference's
own: 2e-5 in fp32, 2e-2 in bf16 (the two sides round bf16 at different
places); paged_write is a copy and must be bit-exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ops import paged_attention
from repro.kernels.paged_write import paged_write as ref_pallas_paged_write
from repro.kernels.ref import ref_paged_decode as jax_ref_paged_decode
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kernels.paged_write import paged_write
from repro_torch.kernels.ref import MAIN_SHAPE_BF16_TOL, ref_paged_decode

# B, Hq, Hkv, D, page, npages, pool  (tests/test_kernels.py PAGED_CASES)
PAGED_CASES = [
    (3, 8, 2, 64, 16, 8, 40),
    (1, 4, 4, 128, 32, 4, 16),
    (2, 8, 1, 64, 16, 16, 64),
    (4, 2, 2, 32, 8, 4, 20),
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
        paged_write(torch.zeros((1, 8, 1, 32), device="meta"),
                    torch.zeros((1, 8, 1, 32), device="meta"), kp, kp,
                    np.ones((1, 1), np.int32), np.ones((1,), np.int32))
