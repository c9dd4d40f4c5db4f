"""Decoder stack for attention-only configs: init, caches, forward.

Port of ``repro.models.model`` for the paged serving path. Layers are
repetitions of ``cfg.layer_pattern`` ("groups"): every full group's
parameters and caches stay stacked on a leading ``n_full`` axis, exactly as
in the reference, whose ``lax.scan`` over that axis becomes a Python loop
here; a remainder "tail" of layers is stored and run one by one.

``forward(cfg, params, tokens, cache=..., pos=...)`` covers the plain
forward (cache=None), full and partial prefill into a dense cache, and the
single-model paged decode step (S=1 over a paged cache). ``decode_stacked``
is the fused plane's step: M decoders' weights stacked on a leading model
axis advance an (M, Bmax) grid of sequences, one ``paged_decode`` launch per
layer over the flattened M * Bmax batch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import (embed_lookup, mlp_apply, rmsnorm,
                                       unembed)


def _group_structure(cfg: ModelConfig):
    pat = cfg.layer_pattern
    n_full = cfg.n_layers // len(pat)
    tail = tuple(pat[: cfg.n_layers % len(pat)])
    return pat, n_full, tail


def _check_supported(cfg: ModelConfig) -> None:
    if any(k != ATTN for k in cfg.layer_kinds()) or cfg.is_moe \
            or cfg.is_encdec or cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: only global-attention token decoders are ported; "
            f"dense-fallback archs arrive in port slice 5")


# ======================================================================
# init


class _Init:
    """Seeded truncated-normal init on the device, one generator per model.

    Same tree keys and shapes as ``repro.models.init_params`` (torch cannot
    reproduce ``jax.random``'s numbers; parity tests carry the reference's
    weights across with ``repro_torch.params.params_from_numpy``). With
    several seeds every leaf gets a leading model axis, filled model by model
    (and layer by layer) so no full-size fp32 temporary is ever made."""

    def __init__(self, seeds, device, dtype, stacked: bool):
        self.gens = [torch.Generator(device=device).manual_seed(int(s))
                     for s in seeds]
        self.device, self.dtype, self.stacked = device, dtype, stacked

    def _fill(self, shape, fn):
        lead = (len(self.gens),) if self.stacked else ()
        out = torch.empty(lead + shape, dtype=self.dtype, device=self.device)
        for m, g in enumerate(self.gens):
            fn(out[m] if self.stacked else out, g)
        return out

    def dense(self, shape, scale=None, layers: int = 0):
        """Truncated normal in [-3, 3] times 1/sqrt(fan_in) (or ``scale``);
        ``layers`` > 0 prepends a stacked layer axis."""
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        std = scale if scale is not None else 1.0 / np.sqrt(fan_in)

        def fn(t, g):
            for sub in (t if layers else [t]):
                tmp = torch.empty(sub.shape, dtype=torch.float32,
                                  device=self.device)
                torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -3.0, 3.0,
                                            generator=g)
                sub.copy_(tmp * std)
        return self._fill(((layers,) if layers else ()) + tuple(shape), fn)

    def zeros(self, shape, layers: int = 0):
        return self._fill(((layers,) if layers else ()) + tuple(shape),
                          lambda t, g: t.zero_())


def _layer_init(ini: _Init, cfg: ModelConfig, layers: int = 0):
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn = {"wq": ini.dense((d, hq * hd), layers=layers),
            "wk": ini.dense((d, hkv * hd), layers=layers),
            "wv": ini.dense((d, hkv * hd), layers=layers),
            "wo": ini.dense((hq * hd, d), layers=layers)}
    if cfg.qk_norm:
        attn["q_norm"] = ini.zeros((hd,), layers=layers)
        attn["k_norm"] = ini.zeros((hd,), layers=layers)
    p = {"norm1": ini.zeros((d,), layers=layers), "attn": attn}
    if cfg.d_ff > 0:
        p["norm2"] = ini.zeros((d,), layers=layers)
        p["mlp"] = {"wi": ini.dense((d, cfg.d_ff), layers=layers),
                    "wu": ini.dense((d, cfg.d_ff), layers=layers),
                    "wo": ini.dense((cfg.d_ff, d), layers=layers)}
    return p


def _init_tree(cfg: ModelConfig, ini: _Init):
    _check_supported(cfg)
    pat, n_full, tail = _group_structure(cfg)
    params = {
        "embed": ini.dense((cfg.vocab_size, cfg.d_model), scale=0.02),
        "final_norm": ini.zeros((cfg.d_model,)),
        "groups": {f"pos{i}": _layer_init(ini, cfg, layers=n_full)
                   for i in range(len(pat))} if n_full else {},
        "tail": [_layer_init(ini, cfg) for _ in tail],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = ini.dense((cfg.vocab_size, cfg.d_model),
                                      scale=0.02)
    return params


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random weights from a seeded generator on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    return _init_tree(cfg, _Init([seed], dev, torch_dtype(cfg.dtype), False))


def init_stacked_params(cfg: ModelConfig, seeds, device=None):
    """``init_params`` for several models at once, every leaf stacked on a
    leading model axis: leaf ``[m]`` equals ``init_params(cfg, seeds[m])``'s.
    The fused decode plane stacks its decoders this way; building the stack
    directly needs no second copy of the weights
    (``core.lora.unstack_params`` gives the per-model views)."""
    dev = resolve_device(device)
    return _init_tree(cfg, _Init(seeds, dev, torch_dtype(cfg.dtype), True))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """Dense working cache: stacked groups plus tail layers, each layer
    ``{"k", "v": (batch, cache_len, Hkv * D), "kpos": (batch, cache_len)}``
    with ``kpos = -1`` for unwritten slots."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    pat, n_full, tail = _group_structure(cfg)
    f = cfg.n_kv_heads * cfg.head_dim

    def layer(lead):
        return {"k": torch.zeros(lead + (batch, cache_len, f), dtype=dtype,
                                 device=dev),
                "v": torch.zeros(lead + (batch, cache_len, f), dtype=dtype,
                                 device=dev),
                "kpos": torch.full(lead + (batch, cache_len), -1,
                                   dtype=torch.int32, device=dev)}

    return {"groups": {f"pos{i}": layer((n_full,)) for i in range(len(pat))}
            if n_full else {},
            "tail": [layer(()) for _ in tail]}


# ======================================================================
# forward


def _layer_slice(tree, layer: int, axis: int):
    """Layer ``layer`` of a stacked group subtree (a view, no copy); ``axis`` is
    1 when the leaves also carry a leading model axis."""
    if isinstance(tree, dict):
        return {k: _layer_slice(v, layer, axis) for k, v in tree.items()}
    return tree.select(axis, layer)


def _cache_slice(cache, layer: int):
    """Layer ``layer`` of a stacked group cache: dense leaves are stacked, a
    paged cache shares one block table across layers."""
    if "k_pages" in cache:
        return {"k_pages": cache["k_pages"][layer], "v_pages": cache["v_pages"][layer],
                "block_tables": cache["block_tables"]}
    return {k: v[layer] for k, v in cache.items()}


def _apply_layer(lp, x, cfg, cache, pos):
    h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
    out, _ = attn_mod.attn_apply(lp["attn"], h, cfg, cache=cache, pos=pos)
    x = x + out
    if "norm2" in lp:
        x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    return x


def _layers(cfg, params, cache, axis: int = 0):
    """(layer params, layer cache) in execution order."""
    pat, n_full, tail = _group_structure(cfg)
    for layer in range(n_full):
        for i in range(len(pat)):
            g = f"pos{i}"
            yield (_layer_slice(params["groups"][g], layer, axis),
                   None if cache is None
                   else _cache_slice(cache["groups"][g], layer))
    for i in range(len(tail)):
        yield params["tail"][i], None if cache is None else cache["tail"][i]


def _embed(cfg, table, index):
    """Embedding rows times sqrt(d), in the model dtype (the reference's
    ``jnp.asarray(sqrt(d), dtype)``). ``index`` is a token tensor, or a
    (model ids, tokens) pair for a stacked table."""
    rows = table[index] if isinstance(index, tuple) else embed_lookup(table,
                                                                      index)
    return rows * torch.tensor(
        cfg.d_model ** 0.5, dtype=table.dtype, device=table.device)


def forward(cfg: ModelConfig, params, tokens, *, cache=None, pos=None,
            logits: str = "last"):
    """Run the decoder stack. tokens: (B, S) int; pos: (B,) int32 absolute
    position of tokens[:, 0] (None -> zeros). Returns (output, cache):
    last-token logits (B, V), all logits (B, S, V) or hidden states
    (B, S, D) for ``logits`` in {"last", "all", "hidden"}. A cache (dense or
    paged) is updated in place and returned."""
    _check_supported(cfg)
    x = _embed(cfg, params["embed"], tokens)
    if pos is None:
        pos = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    for lp, lc in _layers(cfg, params, cache):
        x = _apply_layer(lp, x, cfg, lc, pos)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    table = params.get("unembed", params["embed"])
    if logits == "hidden":
        return x, cache
    if logits == "all":
        return unembed(x, table, cfg.final_softcap), cache
    return unembed(x[:, -1], table, cfg.final_softcap), cache


def decode_stacked(cfg: ModelConfig, stacked, tokens, pos, k_layers,
                   v_layers, block_tables):
    """The fused decode plane's step: ONE forward for M stacked decoders.

    stacked: a param tree whose every leaf has a leading model axis M.
    tokens, pos: (M, Bmax) int (row (m, b) feeds decoder m; padding rows
    carry pos 0 and a block table of sentinel page 0). k/v_layers: each
    layer's (P, page, Hkv, D) pool pages in execution order, shared by all
    models. block_tables: (M * Bmax, npages) int32. Projections and MLPs are
    batched matrix products over the model axis; attention is one
    ``paged_decode`` launch per layer over all M * Bmax rows, each row
    writing its K/V straight into the shared pool. Returns (M, Bmax, V)
    fp32 logits."""
    _check_supported(cfg)
    M, Bmax = tokens.shape
    mid = torch.arange(M, device=tokens.device)[:, None]
    x = _embed(cfg, stacked["embed"], (mid, tokens.long()))   # (M, Bmax, d)
    flat_pos = pos.reshape(-1)
    hq, hd = cfg.n_heads, cfg.head_dim
    layers = _layers(cfg, stacked, None, axis=1)
    for (lp, _), kp, vp in zip(layers, k_layers, v_layers):
        ap = lp["attn"]
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(ap, h, cfg, pos)       # (M, Bmax, H, D)
        o = attn_mod.paged_decode_rows(
            q.reshape(M * Bmax, hq, hd), k.reshape(M * Bmax, -1, hd),
            v.reshape(M * Bmax, -1, hd), kp, vp, block_tables, flat_pos,
            softcap=cfg.attn_softcap)
        x = x + o.reshape(M, Bmax, hq * hd) @ ap["wo"]
        if "norm2" in lp:
            x = x + mlp_apply(lp["mlp"], rmsnorm(x, lp["norm2"], cfg.norm_eps))
    x = rmsnorm(x, stacked["final_norm"], cfg.norm_eps)
    table = stacked.get("unembed", stacked["embed"])
    return unembed(x, table, cfg.final_softcap)
