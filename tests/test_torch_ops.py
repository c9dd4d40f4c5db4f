"""The port's kernel API (``repro_torch.kernels``) against the reference's
(``repro.kernels``), in the model's layout.

The same numpy inputs reach both packages. The reference's wrappers run its
Pallas kernels in interpret mode; the port's, given CPU tensors, run the
kernels' plain versions (the Hopper kernels are held against those on the
card by tests/test_torch_gpu.py and chip_smoke.py). Tolerances are the
reference kernel tests': 2e-5 in fp32, 2e-2 in bf16.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jax_kernels
from repro.kernels.ops import paged_prefill as jax_paged_prefill
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels.flash_prefill import flash_prefill

ROOT = Path(__file__).resolve().parents[1]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# B, Hq, Hkv, S, T, D, causal, window, softcap, scale
FLASH_OPS_CASES = [
    (2, 4, 2, 64, 64, 64, True, 0, 0.0, None),
    (1, 8, 2, 96, 96, 32, True, 24, 30.0, None),
    (1, 4, 1, 48, 80, 32, False, 0, 0.0, 0.2),
]


def _seq_major(B, Hq, Hkv, S, T, D, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, Hq, D), np.float32),
            rng.standard_normal((B, T, Hkv, D), np.float32),
            rng.standard_normal((B, T, Hkv, D), np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", FLASH_OPS_CASES, ids=str)
def test_flash_attention_matches_reference_ops(case, dtype):
    """``kernels.flash_attention`` (seq-major) against
    ``repro.kernels.flash_attention(interpret=True)``, and against the
    head-major ``flash_prefill`` on transposed inputs, which it wraps."""
    B, Hq, Hkv, S, T, D, causal, window, softcap, scale = case
    jdt, tdt, tol = DTYPES[dtype]
    arrays = _seq_major(B, Hq, Hkv, S, T, D)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    want = jax_kernels.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                       interpret=True, **kw)
    q, k, v = (torch.tensor(a).to(tdt) for a in arrays)
    got = kernels.flash_attention(q, k, v, **kw)
    assert got.shape == q.shape and got.dtype == tdt and got.is_contiguous()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)
    head_major = flash_prefill(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), **kw)
    np.testing.assert_array_equal(got.float().numpy(),
                                  head_major.transpose(1, 2).float().numpy())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_prefill_matches_reference_ops(dtype):
    """``kernels.paged_prefill`` against ``repro.kernels.ops.paged_prefill``
    (interpret mode) at chunk starts mid-page, with a softcap."""
    jdt, tdt, tol = DTYPES[dtype]
    B, Hq, Hkv, D, page, npages, P, S = 2, 4, 2, 64, 8, 4, 16, 5
    rng = np.random.default_rng(1)
    q = rng.standard_normal((B, S, Hq, D), np.float32)
    kp, vp = (rng.standard_normal((P, page, Hkv, D), np.float32)
              for _ in range(2))
    bt = rng.integers(0, P, (B, npages)).astype(np.int32)
    st = np.array([3, 20], np.int32)
    want = jax_paged_prefill(jnp.asarray(q, jdt), jnp.asarray(kp, jdt),
                             jnp.asarray(vp, jdt), jnp.asarray(bt),
                             jnp.asarray(st), softcap=30.0, interpret=True)
    got = kernels.paged_prefill(torch.tensor(q).to(tdt),
                                torch.tensor(kp).to(tdt),
                                torch.tensor(vp).to(tdt), torch.tensor(bt),
                                torch.tensor(st), softcap=30.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_attention_matches_reference_ops(dtype):
    """``kernels.paged_attention`` against
    ``repro.kernels.paged_attention(interpret=True)``."""
    jdt, tdt, tol = DTYPES[dtype]
    B, Hq, Hkv, D, page, npages, P = 3, 8, 2, 64, 16, 8, 40
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, Hq, D), np.float32)
    kp, vp = (rng.standard_normal((P, page, Hkv, D), np.float32)
              for _ in range(2))
    bt = rng.integers(0, P, (B, npages)).astype(np.int32)
    ln = rng.integers(1, page * npages + 1, (B,)).astype(np.int32)
    want = jax_kernels.paged_attention(
        jnp.asarray(q, jdt), jnp.asarray(kp, jdt), jnp.asarray(vp, jdt),
        jnp.asarray(bt), jnp.asarray(ln), softcap=30.0, interpret=True)
    got = kernels.paged_attention(torch.tensor(q).to(tdt),
                                  torch.tensor(kp).to(tdt),
                                  torch.tensor(vp).to(tdt),
                                  torch.tensor(bt), torch.tensor(ln),
                                  softcap=30.0)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_kernel_api_exports_the_reference_names():
    """The package exports the reference's public names, plus
    ``paged_prefill``, each the ``ops`` wrapper (or the kernel wrapper)."""
    assert set(kernels.__all__) == {"flash_attention", "paged_attention",
                                    "paged_prefill", "paged_write"}
    for name in ("flash_attention", "paged_attention", "paged_write"):
        assert hasattr(jax_kernels, name)
    assert kernels.flash_attention is ops.flash_attention
    assert kernels.paged_prefill is ops.paged_prefill
    assert kernels.paged_attention is ops.paged_attention


def test_importing_the_kernel_api_builds_nothing():
    """Importing ``repro_torch.kernels`` and every kernel module starts no
    build and loads no library (a kernel builds at its first launch)."""
    code = """
import repro_torch.kernels._build as b
def refuse(*a, **k):
    raise SystemExit("built at import")
b.build_all = refuse
import repro_torch.kernels
from repro_torch.kernels import (flash_prefill, flash_prefill_paged, ops,
                                 paged_decode, paged_write, ref)
assert not b.LIBRARIES._libs
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr
