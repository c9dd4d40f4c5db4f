"""Plain PyTorch reference of the dense decoder language models the
benchmark serves: GQA attention with RoPE, RMSNorm and a SwiGLU MLP; tied
or untied embeddings.

It imports nothing of the port and nothing of JAX. It reads the weights
the harness drew (the port's tree layout: ``embed``, ``unembed`` when
untied, ``final_norm``, ``groups.pos0`` with every leaf stacked on a
leading layer axis) and the token ids the harness made, and works out
again, in float32 with TF32 off, everything the served path derived from
them:

  - the base model's K/V of each prompt (PrefillShare: the decoders read
    the base's cache; the port prefills it in chunks over cached pages);
  - each decoder's logits at the positions it served, fed the tokens it
    served (the first fed token is the handoff token).

Everything is computed one layer at a time, one weight matrix in float32
at a time, so it fits beside the bf16 weights once the engine is freed.
The configuration file lists the departures from the published models.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Q_ROWS = 512        # query rows per attention block
FF_ROWS = 4096      # rows per MLP block


def _fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one scale per slice over
    ``dims`` (the control's precision)."""
    s = t.abs().amax(dim=dims, keepdim=True).clamp(min=1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Precision:
    """float32 (the reference), or the control: the float8 serving path a
    later change could take, W8A8 with per-tensor scales (each weight
    matrix, each matrix product's input) and K/V stored in float8 e4m3
    (one scale per layer's keys, one per its values)."""

    def __init__(self, fp8: bool):
        self.fp8 = fp8

    def w(self, t):
        t = t.float()
        return _fp8(t, (-2, -1)) if self.fp8 else t

    def x(self, t):
        return _fp8(t, tuple(range(t.dim()))) if self.fp8 else t

    kv = x


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (
        1.0 + w.float())


def _rope(x, pos, theta):
    """x (S, H, D); pos (S,) absolute positions; the rotation of the two
    halves of each head (GPT-NeoX layout)."""
    half = x.shape[-1] // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = pos.double()[:, None] * inv[None]
    cos = ang.cos().float()[:, None, :]
    sin = ang.sin().float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, q_pos, k_pos):
    """Causal GQA attention. q (S, Hq, D) roped and scaled; k, v (T, Hkv,
    D); positions 1-D. Returns (S, Hq, D)."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    out = torch.empty_like(q)
    for r0 in range(0, S, Q_ROWS):
        qb = q[r0:r0 + Q_ROWS].reshape(-1, Hkv, Hq // Hkv, D)
        s = torch.einsum("bhgd,thd->hgbt", qb, k)
        mask = k_pos[None, :] <= q_pos[r0:r0 + Q_ROWS, None]
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[r0:r0 + Q_ROWS] = torch.einsum("hgbt,thd->bhgd", p, v).reshape(
            -1, Hq, D)
    return out


def _layer(tree, layer: int, prec) -> dict:
    """One layer's weights in the computing precision: matrices through
    ``prec.w``, norms in float32."""
    def pick(t, name=""):
        if isinstance(t, dict):
            return {k: pick(v, k) for k, v in t.items()}
        t = t[layer]
        return t.float() if name.startswith("norm") else prec.w(t)
    return pick(tree["groups"]["pos0"])


class _Rows:
    """Hidden states of rows at known positions: a prompt's (computed by
    the base) or a decoder's served positions."""

    def __init__(self, h, pos):
        self.h, self.pos = h, pos
        self.k = self.v = None


def _block(rows_list, keys_of, lw, hp, prec):
    """One layer over several row sets. ``keys_of(i)`` gives row set i's
    keys, values and their positions (its own and what it attends to)."""
    eps, hq, hkv, hd = hp["norm_eps"], hp["n_heads"], hp["n_kv_heads"], \
        hp["head_dim"]
    aw = lw["attn"]
    qs = []
    for r in rows_list:
        x = prec.x(_rms(r.h, lw["norm1"], eps))
        q = (x @ aw["wq"]).reshape(-1, hq, hd)
        k = (x @ aw["wk"]).reshape(-1, hkv, hd)
        r.v = prec.kv((x @ aw["wv"]).reshape(-1, hkv, hd))
        r.k = prec.kv(_rope(k, r.pos, hp["rope_theta"]))
        qs.append(_rope(q, r.pos, hp["rope_theta"]) * hd ** -0.5)
    for i, (r, q) in enumerate(zip(rows_list, qs)):
        k, v, kpos = keys_of(i)
        o = _attend(q, k, v, r.pos, kpos).reshape(r.h.shape[0], -1)
        r.h = r.h + prec.x(o) @ aw["wo"]
    mw = lw["mlp"]
    for r in rows_list:
        x = _rms(r.h, lw["norm2"], eps)
        for r0 in range(0, x.shape[0], FF_ROWS):
            h = prec.x(x[r0:r0 + FF_ROWS])
            y = prec.x(F.silu(h @ mw["wi"]) * (h @ mw["wu"])) @ mw["wo"]
            r.h[r0:r0 + FF_ROWS] += y


def _embed(tree, tokens, hp):
    return tree["embed"][tokens].float() * math.sqrt(hp["d_model"])


@torch.no_grad()
def served_logits(hp, base, decoders, items, *, fp8=False):
    """Each item's decoder logits at its served positions.

    ``items``: ``[{"tokens": the prompt, "fed": the tokens fed at
    positions len(prompt).., "model": decoder index}]``. Returns float32
    (len(fed), vocab) tensors. ``fp8=True`` computes the control."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    prec = _Precision(fp8)
    dev = base["embed"].device

    def lt(x):
        return torch.as_tensor(x, dtype=torch.long, device=dev)

    ctx = [_Rows(_embed(base, lt(it["tokens"]), hp),
                 lt(range(len(it["tokens"])))) for it in items]
    dec = [_Rows(_embed(decoders[it["model"]], lt(it["fed"]), hp),
                 lt(range(len(it["tokens"]),
                          len(it["tokens"]) + len(it["fed"]))))
           for it in items]

    for layer in range(hp["n_layers"]):
        _block(ctx, lambda i: (ctx[i].k, ctx[i].v, ctx[i].pos),
               _layer(base, layer, prec), hp, prec)
        for m, dtree in enumerate(decoders):
            mine = [i for i, it in enumerate(items) if it["model"] == m]
            if not mine:
                continue

            def dec_keys(j, mine=mine):
                i = mine[j]
                return (torch.cat([ctx[i].k, dec[i].k]),
                        torch.cat([ctx[i].v, dec[i].v]),
                        torch.cat([ctx[i].pos, dec[i].pos]))
            _block([dec[i] for i in mine], dec_keys,
                   _layer(dtree, layer, prec), hp, prec)
        for r in ctx + dec:
            r.k = r.v = None
    out = []
    for it, r in zip(items, dec):
        tree = decoders[it["model"]]
        table = tree.get("unembed", tree["embed"])
        x = _rms(r.h, tree["final_norm"], hp["norm_eps"])
        out.append(prec.x(x) @ prec.w(table.T))
    return out
