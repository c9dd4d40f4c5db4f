"""The port's differentiable flash attention against the reference's.

``_FlashAttention`` (forward ``_flash``, backward ``_flash_bwd``) against
``jax.vjp`` of the reference's ``attention(..., force_flash=True)`` (its
``custom_vjp``) on the same numpy inputs: small chunks (q_chunk 4,
kv_chunk 8, so several blocks each way), a query group of 2, causal
masks, sliding windows, softcaps and ragged ``k_pos = -1`` slots. fp32:
outputs and dq/dk/dv within rtol 1e-4 / atol 1e-5 (matrix products sum in
another order on each side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import _flash_fwd_impl
from repro.models.attention import attention as jax_attention
from repro_torch.models.attention import _flash, attention

RTOL, ATOL = 1e-4, 1e-5
INT_MAX = np.iinfo(np.int32).max


def _inputs(seed, B=2, Sq=12, Tk=24, Hq=4, Hkv=2, D=16, start=12,
            ragged=True):
    """q at positions start .. start + Sq - 1 over a Tk-slot cache whose
    slots hold positions 0 .. Tk - 1; with ``ragged`` each row's last slots
    are unwritten (-1), a different number per row."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, Hq, D), np.float32)
    k, v = (rng.standard_normal((B, Tk, Hkv, D), np.float32)
            for _ in range(2))
    q_pos = np.tile(np.arange(start, start + Sq, dtype=np.int32), (B, 1))
    k_pos = np.tile(np.arange(Tk, dtype=np.int32), (B, 1))
    if ragged:
        for b in range(B):
            k_pos[b, Tk - 3 - 2 * b:] = -1
    do = rng.standard_normal((B, Sq, Hq, D), np.float32)
    return q, k, v, q_pos, k_pos, do


def _both(q, k, v, q_pos, k_pos, do, **kw):
    """(reference, port): each (o, dq, dk, dv) as numpy."""
    def f(q_, k_, v_):
        return jax_attention(q_, k_, v_, jnp.asarray(q_pos),
                             jnp.asarray(k_pos), force_flash=True, **kw)
    o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    want = [np.asarray(o)] + [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    to = attention(tq, tk, tv, torch.tensor(q_pos), torch.tensor(k_pos),
                   force_flash=True, **kw)
    to.backward(torch.tensor(do))
    got = [to.detach().numpy()] + [t.grad.numpy() for t in (tq, tk, tv)]
    return want, got


CASES = {
    "causal": dict(),
    "window": dict(window=6),
    "softcap": dict(softcap=30.0),
    "window-softcap": dict(window=5, softcap=20.0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_grads_match_reference_vjp(name):
    want, got = _both(*_inputs(0), q_chunk=4, kv_chunk=8, **CASES[name])
    for label, w, g in zip(("o", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=label)


@pytest.mark.parametrize("window", [0, 7])
def test_self_attention_grads_match_reference_vjp(window):
    """Sq == Tk, k_pos == q_pos (a training forward's self-attention):
    the first q chunk's rows see keys in the first kv chunk only."""
    q, k, v, _, _, do = _inputs(1, Sq=16, Tk=16, ragged=False)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    want, got = _both(q, k, v, pos, pos, do, q_chunk=4, kv_chunk=8,
                      window=window, softcap=25.0)
    for label, w, g in zip(("o", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=label)


def test_unmasked_queries_grads_match_reference_vjp():
    """Every query sees every valid key (cross-attention's q_pos = int32
    max, and the encoder's), a query group of 2, ragged slots."""
    q, k, v, _, k_pos, do = _inputs(2, Sq=8, Tk=16)
    q_pos = np.full((2, 8), INT_MAX, np.int32)
    want, got = _both(q, k, v, q_pos, k_pos, do, q_chunk=4, kv_chunk=8)
    for label, w, g in zip(("o", "dq", "dk", "dv"), want, got):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL, err_msg=label)


def test_flash_lse_matches_reference():
    """``_flash`` returns the reference's log-sum-exp, (B, Hkv, G, Sq),
    and the same output."""
    q, k, v, q_pos, k_pos, _ = _inputs(3)
    qg = (q * 16 ** -0.5).reshape(2, 12, 2, 2, 16)
    wo, wl = _flash_fwd_impl(*(jnp.asarray(a) for a in (qg, k, v, q_pos,
                                                        k_pos)),
                             6, 30.0, 4, 8)
    go, gl = _flash(*(torch.tensor(a) for a in (qg, k, v, q_pos, k_pos)),
                    6, 30.0, 4, 8)
    assert gl.shape == (2, 2, 2, 12) and gl.dtype == torch.float32
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(go.numpy(), np.asarray(wo), rtol=RTOL,
                               atol=ATOL)


def test_flash_saves_only_inputs_output_and_lse():
    """The autograd node keeps (qg, k, v, q_pos, k_pos, o, lse), never a
    chunk's scores: nothing of (Sq, Tk) size."""
    q, k, v, q_pos, k_pos, _ = _inputs(4)
    tq = torch.tensor(q, requires_grad=True)
    out = attention(tq, torch.tensor(k), torch.tensor(v),
                    torch.tensor(q_pos), torch.tensor(k_pos),
                    force_flash=True, q_chunk=4, kv_chunk=8)
    node = out.grad_fn
    while type(node).__name__ != "_FlashAttentionBackward":
        node = node.next_functions[0][0]
    shapes = [tuple(t.shape) for t in node.saved_tensors]
    assert shapes == [(2, 12, 2, 2, 16), (2, 24, 2, 16), (2, 24, 2, 16),
                      (2, 12), (2, 24), (2, 12, 2, 2, 16), (2, 2, 2, 12)]


def test_flash_grads_match_direct_autograd():
    """The hand-written backward equals autograd through the port's own
    materialized ``_direct`` path (an independent check of the chain
    rule, softcap included)."""
    q, k, v, q_pos, k_pos, do = _inputs(5)
    grads = {}
    for flash in (True, False):
        ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
        out = attention(*ts, torch.tensor(q_pos), torch.tensor(k_pos),
                        window=6, softcap=30.0, force_flash=flash,
                        q_chunk=4, kv_chunk=8)
        out.backward(torch.tensor(do))
        grads[flash] = [out.detach()] + [t.grad for t in ts]
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=RTOL, atol=ATOL)
