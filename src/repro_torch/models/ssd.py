"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060].

Port of ``repro.models.ssd``. The chunked algorithm: an intra-chunk
quadratic (attention-like) term plus an inter-chunk state recurrence, O(S*Q)
compute and O(1) state. The prefill-produced state (ssm state, conv state)
is this architecture's sequence state: prefill emits it, decode consumes
it, like a KV cache of constant size. The state, ``A_log``, ``dt_bias`` and
``D`` stay fp32 under a bf16 config.

The reference's multi-operand einsums are taken two operands at a time
here, so a step never materializes a (chunk x chunk x heads x head_dim)
product; the sums round differently, within the fp32 tolerance of the
parity tests.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import is_dtensor, pin_grad


def ssd_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    nheads = d_in // cfg.ssm_head_dim
    return d_in, nheads, cfg.ssm_head_dim, cfg.ssm_state


def ssd_init(ini, cfg, layers: int = 0):
    """The reference's ``ssd_init`` tree from the seeded initializer ``ini``
    (``models.model._Init``)."""
    d = cfg.d_model
    d_in, nh, _, n = ssd_dims(cfg)
    conv_dim = d_in + 2 * n          # conv over concat(x, B, C), n_groups=1
    f32 = torch.float32
    return {
        # in_proj -> [z (d_in), x (d_in), B (n), C (n), dt (nh)]
        "in_proj": ini.dense((d, 2 * d_in + 2 * n + nh), layers=layers),
        "conv_w": ini.dense((cfg.conv_width, conv_dim), scale=0.5,
                            layers=layers),
        "conv_b": ini.zeros((conv_dim,), layers=layers),
        "A_log": ini.const(torch.log(torch.linspace(1.0, 16.0, nh)),
                           layers=layers, dtype=f32),
        "dt_bias": ini.zeros((nh,), layers=layers, dtype=f32),
        "D": ini.const(torch.ones(nh), layers=layers, dtype=f32),
        "norm_w": ini.zeros((d_in,), layers=layers),  # gated RMSNorm
        "out_proj": ini.dense((d_in, d), layers=layers),
    }


def init_ssd_cache(cfg, batch, dtype, device, lead=()):
    d_in, nh, pdim, n = ssd_dims(cfg)
    conv_dim = d_in + 2 * n
    return {
        "ssm": torch.zeros(lead + (batch, nh, pdim, n), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(lead + (batch, cfg.conv_width - 1, conv_dim),
                            dtype=dtype, device=device),
    }


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def _causal_conv(x, w, b, conv_state):
    """x: (B,S,C), w: (W,C) depthwise. conv_state: (B,W-1,C) left context."""
    W = w.shape[0]
    xp = torch.cat([conv_state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(W))
    new_state = xp[:, -(W - 1):] if W > 1 else conv_state
    return F.silu(out + b), new_state


def _segsum(a):
    """a: (..., L) -> cumulative sums a_i+..+a_j for j<i, (..., L, L)
    lower-triangular (-inf above the diagonal)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]   # diff[i, j] = a_{j+1}+..+a_i
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, torch.tensor(float("-inf"),
                                                device=a.device))


def ssd_scan(x, dt, A, B_, C_, init_state, chunk: int = 64):
    """Chunked SSD.

    x: (B,S,H,P) inputs; dt: (B,S,H) positive step sizes; A: (H,) negative;
    B_, C_: (B,S,N) (single group, broadcast over heads); init_state
    (B,H,P,N). Returns (y (B,S,H,P), final_state)."""
    Bb, S, H, P = x.shape
    N = B_.shape[-1]
    Q = chunk
    while S % Q:
        Q //= 2
    nc = S // Q

    a = dt * A[None, None, :]                       # (B,S,H) log-decay
    xc = x.reshape(Bb, nc, Q, H, P)
    ac = a.reshape(Bb, nc, Q, H).permute(0, 3, 1, 2)  # (B,H,nc,Q)
    dtc = dt.reshape(Bb, nc, Q, H)
    Bc = B_.reshape(Bb, nc, Q, N)
    Cc = C_.reshape(Bb, nc, Q, N)

    a_cum = torch.cumsum(ac, dim=-1)                # (B,H,nc,Q)

    # intra-chunk (diagonal) term: attention-like with a decay kernel
    L = torch.exp(_segsum(ac))                      # (B,H,nc,Q,Q)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)  # (B,nc,Q,Q)
    wts = scores[:, None] * L * dtc.permute(0, 3, 1, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bhcls,bcshp->bclhp", wts, xc)

    # per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)  # (B,H,nc,Q)
    wx = xc * (decay_states.permute(0, 2, 3, 1) * dtc)[..., None]
    states = torch.einsum("bcln,bclhp->bchpn", Bc, wx)

    # inter-chunk recurrence: the state ENTERING each chunk
    chunk_decay = torch.exp(a_cum[..., -1])         # (B,H,nc)
    carry = init_state
    entry = []
    for c in range(nc):
        entry.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    entry_states = torch.stack(entry, dim=1)        # (B,nc,H,P,N)

    # contribution of the entering state to each position in the chunk
    state_decay = torch.exp(a_cum)                  # (B,H,nc,Q)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, entry_states) \
        * state_decay.permute(0, 2, 3, 1)[..., None]

    y = (y_diag + y_off).reshape(Bb, S, H, P)
    return y, carry


def _scan_rows(x, dt, A, B_, C_, init_state):
    """``ssd_scan`` on the dry run's DTensors, run on each rank's local
    batch rows, heads on ``model`` where they divide (``local_map``): the
    scan is independent per (row, head), so no collective runs inside it.
    Its einsums would otherwise merge batch, chunk and head into one
    ``bmm`` batch dim that two mesh dims shard, which DTensor refuses."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    rows = tuple(p if p.is_shard(0) else Replicate() for p in x.placements)
    model = names.index("model") if "model" in names else None
    split = model is not None and x.shape[2] % mesh.size(model) == 0

    def heads(dim: int, base: tuple = rows) -> tuple:
        pl = list(base)
        if split:
            pl[model] = Shard(dim)
        return tuple(pl)

    def placed(t, pl):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(placements=pl)

    in_pl = (heads(2), heads(2), heads(0, (Replicate(),) * mesh.ndim),
             rows, rows, heads(1))
    fn = local_map(ssd_scan, out_placements=(heads(2), heads(1)),
                   in_placements=in_pl, device_mesh=mesh)
    return fn(*(placed(t, pl) for t, pl in
                zip((x, dt, A, B_, C_, init_state), in_pl)))


def ssd_apply(p, x, cfg, cache=None):
    """x: (B,S,D) -> (out, {"ssm", "conv"}). Handles prefill, partial
    prefill (``cache`` holds the state so far) and decode (S = 1, the
    single-step recurrence)."""
    Bb, S, D = x.shape
    d_in, nh, pdim, n = ssd_dims(cfg)
    proj = pin_grad(x @ p["in_proj"])
    z, xin, Bmat, Cmat, dt = torch.split(proj, [d_in, d_in, n, n, nh], dim=-1)

    conv_state = cache["conv"] if cache is not None else torch.zeros(
        (Bb, cfg.conv_width - 1, d_in + 2 * n), dtype=x.dtype,
        device=x.device)
    conv_in = torch.cat([xin, Bmat, Cmat], dim=-1)
    conv_out, new_conv = _causal_conv(conv_in, p["conv_w"], p["conv_b"],
                                      conv_state)
    xin, Bmat, Cmat = torch.split(conv_out, [d_in, n, n], dim=-1)

    dt = softplus(dt.float() + p["dt_bias"])                       # (B,S,H)
    A = -torch.exp(p["A_log"])                                     # (H,)
    xh = xin.reshape(Bb, S, nh, pdim).float()
    init_state = cache["ssm"] if cache is not None else torch.zeros(
        (Bb, nh, pdim, n), dtype=torch.float32, device=x.device)

    if S == 1:
        # single-step recurrence (decode)
        da = torch.exp(dt[:, 0, :] * A[None])                      # (B,H)
        upd = (dt[:, 0, :, None] * xh[:, 0])[..., None] \
            * Bmat[:, 0].float()[:, None, None, :]                 # (B,H,P,N)
        state = init_state * da[..., None, None] + upd
        y = torch.einsum("bn,bhpn->bhp", Cmat[:, 0].float(), state)[:, None]
        final_state = state
    else:
        y, final_state = (_scan_rows if is_dtensor(xh) else ssd_scan)(
            xh, dt, A, Bmat.float(), Cmat.float(), init_state)

    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(Bb, S, d_in).to(x.dtype)

    # gated RMSNorm (mamba2's norm before out_proj)
    yf = (y * F.silu(z)).float()
    var = yf.square().mean(-1, keepdim=True)
    yn = (yf * torch.rsqrt(var + cfg.norm_eps)
          * (1.0 + p["norm_w"].float())).to(x.dtype)
    return yn @ p["out_proj"], {"ssm": final_state, "conv": new_conv}
