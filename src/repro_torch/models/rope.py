"""Rotary position embeddings: full (llama/neox), partial (ChatGLM 2d-style), none."""
from __future__ import annotations

import torch


def _rotate(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE over the last dim of ``x`` (..., S, D) with ``positions`` (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions[..., None].float() * freq          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, style: str = "full",
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) absolute token positions."""
    if style == "none":
        return x
    xt = x.transpose(1, 2)                 # (B, H, S, D)
    pos = positions[:, None, :]            # (B, 1, S)
    if style == "full":
        out = _rotate(xt, pos, theta)
    elif style == "partial":
        # ChatGLM-style: rotary on the first half of head dims, pass-through rest.
        d = xt.shape[-1]
        rot, keep = xt[..., : d // 2], xt[..., d // 2:]
        out = torch.cat([_rotate(rot, pos, theta), keep], dim=-1)
    else:
        raise ValueError(f"unknown rope style {style!r}")
    return out.transpose(1, 2)
