"""The SSD (Mamba-2) and RG-LRU (Griffin) blocks of the port against a
naive per-step recurrence and against the reference
(tests/test_models_units.py's analogues), fp32:

- ``ssd_scan`` against the naive recurrence (1e-4, the reference test's
  tolerance) and against ``repro.models.ssd.ssd_scan`` (1e-5), chunk
  lengths that halve until they divide S, a nonzero initial state;
- ``ssd_apply`` and ``rglru_apply`` against the reference's on its own
  weights, from a carried state; a decode step (S = 1) equal to the last
  position of the prefill, state included;
- the RG-LRU's log-depth scan against a sequential loop (fp32 within
  1e-5: another association order than ``lax.associative_scan``), and a
  bounded state over 100 steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.models import rglru as jrglru
from repro.models import ssd as jssd
from repro_torch.configs.base import ModelConfig
from repro_torch.models import rglru as trglru
from repro_torch.models import ssd as tssd
from repro_torch.params import params_from_numpy

SSD_KW = dict(name="m", arch_type="ssm", n_layers=1, d_model=32, n_heads=0,
              n_kv_heads=0, d_ff=0, vocab_size=16, ssm_state=8,
              ssm_head_dim=16, layer_pattern=("ssd",), dtype="float32")
RGLRU_KW = dict(name="g", arch_type="hybrid", n_layers=1, d_model=32,
                n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=16,
                rglru_width=32, layer_pattern=("rglru",), dtype="float32")


def _naive_ssd(x, dt, A, B_, C_, state):
    ys = []
    for t in range(x.shape[1]):
        da = torch.exp(dt[:, t, :] * A[None])
        upd = torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], B_[:, t])
        state = state * da[..., None, None] + upd
        ys.append(torch.einsum("bn,bhpn->bhp", C_[:, t], state))
    return torch.stack(ys, 1), state


def _scan_inputs(S, seed=0, Bb=2, H=3, P=4, N=8):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bb, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S, H)))).astype(f)
    A = -np.exp(0.3 * rng.standard_normal(H)).astype(f)
    B_ = rng.standard_normal((Bb, S, N)).astype(f)
    C_ = rng.standard_normal((Bb, S, N)).astype(f)
    s0 = (0.5 * rng.standard_normal((Bb, H, P, N))).astype(f)
    return x, dt, A, B_, C_, s0


@pytest.mark.parametrize("S", [1, 7, 64, 100, 130])
def test_ssd_scan_matches_naive_and_reference(S):
    args = _scan_inputs(S)
    t = [torch.tensor(a) for a in args]
    y, f = tssd.ssd_scan(*t, chunk=16)
    yn, fn = _naive_ssd(*t)
    torch.testing.assert_close(y, yn, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(f, fn, atol=1e-4, rtol=1e-4)
    yj, fj = jssd.ssd_scan(*(jnp.asarray(a) for a in args), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(fj), atol=1e-5,
                               rtol=1e-5)


def test_ssd_scan_uses_the_initial_state():
    x, dt, A, B_, C_, s0 = (torch.tensor(a) for a in _scan_inputs(8))
    y0, _ = tssd.ssd_scan(x, dt, A, B_, C_, torch.zeros_like(s0), chunk=4)
    y1, _ = tssd.ssd_scan(x, dt, A, B_, C_, s0, chunk=4)
    assert float((y0 - y1).abs().max()) > 1e-4


def _block(kind):
    """(reference cfg, port cfg, reference params, port params, init cache
    fns, apply fns) of one SSD or RG-LRU block."""
    if kind == "ssd":
        jcfg, tcfg = JModelConfig(**SSD_KW), ModelConfig(**SSD_KW)
        jp = jssd.ssd_init(jax.random.PRNGKey(0), jcfg)
        fns = (jssd.init_ssd_cache, tssd.init_ssd_cache, jssd.ssd_apply,
               tssd.ssd_apply)
    else:
        jcfg, tcfg = JModelConfig(**RGLRU_KW), ModelConfig(**RGLRU_KW)
        jp = jrglru.rglru_init(jax.random.PRNGKey(0), jcfg)
        fns = (jrglru.init_rglru_cache, trglru.init_rglru_cache,
               jrglru.rglru_apply, trglru.rglru_apply)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp, fns


@pytest.mark.parametrize("S", [1, 9, 70])
@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_block_matches_reference_from_a_carried_state(kind, S):
    jcfg, tcfg, jp, tp, (jinit, tinit, japply, tapply) = _block(kind)
    rng = np.random.default_rng(S)
    x = (0.3 * rng.standard_normal((2, S, 32))).astype(np.float32)
    jc = jax.tree.map(
        lambda a: jnp.asarray(0.1 * rng.standard_normal(a.shape), a.dtype),
        jinit(jcfg, 2, jnp.float32))
    tc = {k: torch.tensor(np.asarray(v)) for k, v in jc.items()}
    want, jnew = japply(jp, jnp.asarray(x), jcfg, cache=jc)
    got, tnew = tapply(tp, torch.tensor(x), tcfg, cache=tc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for k in jnew:
        np.testing.assert_allclose(tnew[k].numpy(), np.asarray(jnew[k]),
                                   atol=1e-5, rtol=1e-5)
    empty = tinit(tcfg, 2, torch.float32, "cpu")
    assert {k: tuple(v.shape) for k, v in empty.items()} == \
        {k: tuple(v.shape) for k, v in jc.items()}


@pytest.mark.parametrize("kind", ["ssd", "rglru"])
def test_decode_step_equals_prefill(kind):
    """Prefill 8 tokens, then decode the 9th (S = 1): the 9-token prefill's
    last output and final state."""
    _, tcfg, _, tp, (_, tinit, _, tapply) = _block(kind)
    x = 0.3 * torch.randn((2, 9, 32), generator=torch.Generator()
                          .manual_seed(0))
    full, cf = tapply(tp, x, tcfg, cache=tinit(tcfg, 2, torch.float32, "cpu"))
    _, c = tapply(tp, x[:, :8], tcfg,
                  cache=tinit(tcfg, 2, torch.float32, "cpu"))
    last, c = tapply(tp, x[:, 8:9], tcfg, cache=c)
    torch.testing.assert_close(last[:, 0], full[:, -1], atol=1e-4, rtol=1e-4)
    for k in cf:
        torch.testing.assert_close(c[k], cf[k], atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("S", [1, 2, 5, 64, 100])
def test_linear_scan_matches_sequential_loop(S):
    g = torch.Generator().manual_seed(S)
    a = torch.rand((2, S, 6), generator=g)
    b = torch.randn((2, S, 6), generator=g)
    h, want = torch.zeros((2, 6)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    torch.testing.assert_close(trglru.linear_scan(a, b),
                               torch.stack(want, 1), atol=1e-5, rtol=1e-5)


def test_rglru_state_stays_bounded():
    _, tcfg, _, tp, (_, tinit, _, tapply) = _block("rglru")
    x = torch.randn((1, 100, 32), generator=torch.Generator().manual_seed(1))
    out, cache = tapply(tp, x, tcfg, cache=tinit(tcfg, 1, torch.float32,
                                                 "cpu"))
    assert torch.isfinite(out).all()
    assert float(cache["h"].abs().max()) < 100.0
