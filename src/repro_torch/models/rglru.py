"""RG-LRU recurrent block (Griffin / RecurrentGemma) [arXiv:2402.19427].

Port of ``repro.models.rglru``. x -> {a linear gate branch (GeLU, tanh
approximation as ``jax.nn.gelu``), a linear recurrent branch -> causal conv
-> RG-LRU} -> elementwise product -> out projection.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a h_in + b_a);  i_t = sigmoid(W_x h_in + b_x)
    a_t = exp(-c * softplus(lam) * r_t)          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The linear recurrence h_t = a_t h_{t-1} + b_t runs as a log-depth
(Hillis-Steele) scan over the sequence for prefill, the reference's
``lax.associative_scan`` with another association order (its sums agree to
fp32 rounding, not bit for bit), and as one step for decode. The
recurrent state (and the conv state) is this hybrid's sequence state.
``b_a``, ``b_i``, ``lam`` and the state stay fp32 under a bf16 config.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import pin_grad
from repro_torch.models.ssd import softplus

_C = 8.0


def rglru_width(cfg):
    return cfg.rglru_width or cfg.d_model


def rglru_init(ini, cfg, layers: int = 0):
    """The reference's ``rglru_init`` tree from the seeded initializer
    ``ini`` (``models.model._Init``)."""
    d = cfg.d_model
    w = rglru_width(cfg)
    f32 = torch.float32
    return {
        "in_x": ini.dense((d, w), layers=layers),        # recurrent branch
        "in_gate": ini.dense((d, w), layers=layers),     # gelu gate branch
        "conv_w": ini.dense((cfg.conv_width, w), scale=0.5, layers=layers),
        "conv_b": ini.zeros((w,), layers=layers),
        "w_a": ini.dense((w, w), scale=0.02, layers=layers),
        "b_a": ini.zeros((w,), layers=layers, dtype=f32),
        "w_i": ini.dense((w, w), scale=0.02, layers=layers),
        "b_i": ini.zeros((w,), layers=layers, dtype=f32),
        "lam": ini.full((w,), 0.65, layers=layers, dtype=f32),
        "out": ini.dense((w, d), layers=layers),
    }


def init_rglru_cache(cfg, batch, dtype, device, lead=()):
    w = rglru_width(cfg)
    return {
        "h": torch.zeros(lead + (batch, w), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, w),
                            dtype=dtype, device=device),
    }


def _conv(x, w, b, state):
    W = w.shape[0]
    xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else state
    return out + b, new_state


def linear_scan(a, b):
    """All prefixes of h_t = a_t h_{t-1} + b_t (h_{-1} = 0) over axis 1,
    in ceil(log2 S) steps: after the step of distance d, (a_t, b_t) compose
    the 2d steps ending at t (the reference's ``combine``: (al * ar,
    br + ar * bl))."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], b[:, d:] + a[:, d:] * b[:, :-d]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_apply(p, x, cfg, cache=None):
    """x: (B,S,D) -> (out, {"h", "conv"})."""
    B, S, D = x.shape
    w = rglru_width(cfg)
    xr = x @ p["in_x"]
    gate = F.gelu(x @ p["in_gate"], approximate="tanh")

    conv_state = cache["conv"] if cache is not None else torch.zeros(
        (B, cfg.conv_width - 1, w), dtype=x.dtype, device=x.device)
    xc, new_conv = _conv(xr, p["conv_w"], p["conv_b"], conv_state)

    r = torch.sigmoid(pin_grad(xc @ p["w_a"]).float() + p["b_a"])
    i = torch.sigmoid(pin_grad(xc @ p["w_i"]).float() + p["b_i"])
    log_a = -_C * softplus(p["lam"]) * r                         # (B,S,W) < 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i * xc.float())

    h0 = cache["h"] if cache is not None else torch.zeros(
        (B, w), dtype=torch.float32, device=x.device)
    if S == 1:
        hs = (a[:, 0] * h0 + b[:, 0])[:, None]
    else:
        # fold the initial state into the first step, then scan
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
        hs = linear_scan(a, b)
    out = (hs.to(x.dtype) * gate) @ p["out"]
    return out, {"h": hs[:, -1], "conv": new_conv}
