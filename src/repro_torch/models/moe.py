"""Mixture-of-Experts: capacity-based top-k routing with gather dispatch.

Port of ``repro.models.moe``. Routing is per batch row: each row's S * K
(token, expert) choices take slots in s-major, then k, order, and a choice
past an expert's capacity ``C`` (``_capacity``, from the row's S) is
dropped. The slot -> token map is a scatter, the dispatch a gather of the
row's activations into ``(E, C)`` expert slots, the combine a gather of each
choice's slot output weighted by its renormalized gate and summed over k in
the reference's order. The router runs in fp32.

The expert products are plain batched matrix products over every expert's
``C`` slots, as in the reference (its ``(B, E*C, D)`` einsum): an expert
with no routed token computes on zero rows. At the decode step (S = 1, so
C = 1 and nothing is ever dropped) that reads every expert's weights once
per layer, which is what the fused decode plane does.

In the sharded dry run the routing runs on each rank's local batch rows
(``local_map``) while the expert products stay DTensor operations on the
experts' own shards.

Weights may carry a leading model axis M (the fused decode plane's stacked
decoders): then ``x`` is ``(M, B, S, D)``. A LoRA group's lanes stack only
the adapted ``wo`` on M; the other expert weights are the base's, with no
model axis, and are read once for all lanes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import is_dtensor, pin_grad


def moe_init(ini, cfg, layers: int = 0):
    """The reference's ``moe_init`` tree from the seeded initializer ``ini``
    (``models.model._Init``); the router is fp32 under any config dtype."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": ini.dense((d, e), scale=0.02, layers=layers,
                             dtype=torch.float32),
         "wi": ini.dense((e, d, f), layers=layers),
         "wu": ini.dense((e, d, f), layers=layers),
         "wo": ini.dense((e, f, d), layers=layers)}
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared"] = {"wi": ini.dense((d, fs), layers=layers),
                       "wu": ini.dense((d, fs), layers=layers),
                       "wo": ini.dense((fs, d), layers=layers)}
    return p


def _capacity(cfg, tokens_per_row: int) -> int:
    c = int(cfg.capacity_factor * cfg.top_k * tokens_per_row / cfg.n_experts)
    return max(1, min(c, tokens_per_row))  # a token hits K *distinct* experts


def _top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest, descending, the lower index first
    on ties (a stable descending sort; ``torch.topk`` promises no order on
    ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _expert_mm(xe, w):
    """Per-expert products: ``xe`` (..., E, N, K) against ``w`` (..., E, K,
    F). A weight without the activation's leading model axis folds that
    axis into the rows, so it is never expanded per lane."""
    if w.dim() == xe.dim():
        return xe @ w
    M, E, N, K = xe.shape
    out = xe.transpose(0, 1).reshape(E, M * N, K) @ w
    return out.reshape(E, M, N, -1).transpose(0, 1)


def _router(x, router):
    """fp32 router logits: ``x`` (..., B, S, D) against ``router`` (D, E),
    or (M, D, E) for an ``x`` with a leading model axis."""
    if router.dim() == 3:
        router = router[:, None]
    return x.float() @ router


def _route(probs, K: int, C: int):
    """The capacity assignment of each batch row of ``probs`` (..., S, E):
    the renormalized top-k gate values (..., S, K), the one-hot choices
    (..., S*K, E), which choices keep a slot, each choice's slot (E*C for a
    dropped one), and each slot's source token with its validity."""
    *lead, S, E = probs.shape
    TK = S * K
    gate_vals, gate_idx = _top_k(probs, K)                        # (...,S,K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # --- capacity assignment, per batch row ---
    e_flat = gate_idx.reshape(*lead, TK)                          # expert per (s,k)
    oh = F.one_hot(e_flat, E).to(torch.int32)                     # (...,TK,E)
    pos = torch.cumsum(oh, dim=-2, dtype=torch.int32) - oh
    pos_in_expert = (pos * oh).sum(-1)                            # (...,TK)
    keep = pos_in_expert < C

    # --- slot -> token map via scatter (E*C is the drop sentinel) ---
    slot = torch.where(keep, e_flat * C + pos_in_expert,
                       torch.full_like(e_flat, E * C))
    src = torch.arange(TK, device=probs.device).expand(*lead, TK)
    token_of_slot = torch.full((*lead, E * C + 1), TK, dtype=torch.int64,
                               device=probs.device)
    token_of_slot.scatter_(-1, slot, src)
    token_of_slot = token_of_slot[..., :E * C]
    slot_valid = token_of_slot < TK                               # (...,E*C)
    src_tok = torch.clamp(token_of_slot // K, max=S - 1)
    return gate_vals, oh, keep, slot, slot_valid, src_tok


def _route_rows(probs, K: int, C: int):
    """``_route`` on the dry run's DTensors: every index is within a batch
    row, so it runs on each rank's local rows (``local_map``) with the
    experts whole; no collective runs inside it and no weight enters."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    rows = tuple(p if p.is_shard(0) else Replicate()
                 for p in probs.placements)
    fn = local_map(lambda pr: _route(pr, K, C), out_placements=(rows,) * 6,
                   in_placements=(rows,), device_mesh=probs.device_mesh,
                   redistribute_inputs=True)
    return fn(probs)


def moe_apply(p, x, cfg):
    """x: (B, S, D), or (M, B, S, D) with stacked weights -> (out of x's
    shape, aux {"lb_loss", "dropped_frac"})."""
    *lead, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(cfg, S)
    TK = S * K
    dev = x.device

    probs = torch.softmax(pin_grad(_router(x, p["router"])), dim=-1)
    gate_vals, oh, keep, slot, slot_valid, src_tok = (
        _route_rows if is_dtensor(probs) else _route)(probs, K, C)

    # --- dispatch: gather token activations into expert slots ---
    exp_in = torch.gather(x, -2, src_tok[..., None].expand(*lead, E * C, D))
    exp_in = torch.where(slot_valid[..., None], exp_in,
                         torch.zeros((), dtype=x.dtype, device=dev))
    # (..., B, E, C, D) -> (..., E, B*C, D): one product per expert
    nb = len(lead) - 1
    B = lead[-1]
    xe = exp_in.reshape(*lead, E, C, D).transpose(nb, nb + 1).reshape(
        *lead[:-1], E, B * C, D)
    g = _expert_mm(xe, p["wi"])
    u = _expert_mm(xe, p["wu"])
    h = F.silu(g) * u
    exp_out = _expert_mm(h, p["wo"]).reshape(*lead[:-1], E, B, C, D)
    exp_out = exp_out.transpose(nb, nb + 1).reshape(*lead, E * C, D)

    # --- combine: each (token, k)'s slot output, weighted, summed over k ---
    gathered = torch.gather(
        exp_out, -2,
        torch.clamp(slot, max=E * C - 1)[..., None].expand(*lead, TK, D))
    gathered = torch.where(keep[..., None], gathered,
                           torch.zeros((), dtype=gathered.dtype, device=dev))
    w = gate_vals.reshape(*lead, TK)[..., None].to(gathered.dtype)
    out = (gathered * w).reshape(*lead, S, K, D).sum(-2)

    if "shared" in p:
        sp = p["shared"]
        xs = x.flatten(1, -2) if len(lead) == 2 else x   # (M, B*S, D)
        gs, us = xs @ sp["wi"], xs @ sp["wu"]
        out = out + ((F.silu(gs) * us) @ sp["wo"]).reshape(out.shape)

    lead_axes = tuple(range(len(lead) + 1))                       # (..., S)
    me = probs.mean(dim=lead_axes)                                # (E,)
    ce = oh.reshape(*lead, S, K, E).sum(-2).float().mean(dim=lead_axes)
    aux = {"lb_loss": E * torch.sum(me * ce),
           "dropped_frac": 1.0 - keep.float().mean()}
    return out.to(x.dtype), aux
