"""Primitive layers: RMSNorm, embedding, gated MLP, unembedding.

Numerics follow ``repro.models.layers``: RMSNorm stores ``scale - 1`` and
computes in fp32; the MLP is SwiGLU; ``unembed`` computes in the model
dtype, casts to fp32, then applies the optional softcap. Weights may carry a
leading model axis ``M`` (the fused decode plane's stacked decoders): every
function here broadcasts ``(M, ...)`` weights against ``(M, N, ...)``
activations through ``torch.matmul``'s batch rule.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def bcast(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """View a per-feature weight for broadcasting against ``x``: an
    unstacked ``(F,)`` weight as is, a stacked ``(M, F)`` weight as
    ``(M, 1, ..., F)`` against an ``(M, ..., F)`` activation."""
    if w.dim() == 1:
        return w
    return w.reshape(w.shape[:1] + (1,) * (x.dim() - w.dim()) + w.shape[1:])


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + bcast(w, x).float())).to(dt)


def mlp_apply(p, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU gated MLP."""
    g = x @ p["wi"]
    u = x @ p["wu"]
    return (F.silu(g) * u) @ p["wo"]


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens.long()]


def unembed(x: torch.Tensor, table: torch.Tensor, softcap=None) -> torch.Tensor:
    logits = (x @ table.transpose(-1, -2)).float()
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    return logits
