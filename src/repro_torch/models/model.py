"""Composable model: one stack covering dense / MoE / SSM / hybrid /
enc-dec / mixed-input configs: init, caches, forward.

Port of ``repro.models.model``. Layers are repetitions of
``cfg.layer_pattern`` ("groups"): every full group's parameters and caches
stay stacked on a leading ``n_full`` axis, exactly as in the reference,
whose ``lax.scan`` over that axis becomes a Python loop here; a remainder
"tail" of layers (recurrentgemma's 26 = 8 * 3 + 2) is stored and run one by
one. A layer is global attention (``ATTN``), sliding-window attention
(``LOCAL_ATTN``), an RG-LRU block or an SSD block, followed (except SSD) by
a gated MLP or a mixture of experts; an enc-dec decoder adds a
cross-attention block over the encoder output (``encode``).

``forward(cfg, params, tokens, cache=..., pos=...)`` covers the plain
forward (cache=None), full and partial prefill into a dense cache, dense
decode (S=1), and the single-model paged step over a paged cache (global
attention only). ``decode_stacked`` is the fused plane's step: M decoders'
weights stacked on a leading model axis advance an (M, Bmax) grid of
sequences, one ``paged_decode`` launch per layer over the flattened
M * Bmax batch. Serving updates caches in place; while autograd records
(training) the forward is functional and returns new caches instead.
``train_loss`` is the chunked next-token cross-entropy of pretraining and
full fine-tuning.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN, LOCAL_ATTN, RGLRU, SSD, ModelConfig
from repro_torch.device import resolve_device, torch_dtype
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (embed_lookup, is_dtensor, mlp_apply,
                                       pin_grad, rmsnorm, unembed)
from repro_torch.params import tree_leaves, tree_map

_KINDS = (ATTN, LOCAL_ATTN, RGLRU, SSD)

#: Sharding hook of the dry run (``launch/steps.py`` sets it): DTensor
#: placements that every layer's input, the (B, S, D) residual stream, is
#: redistributed to, as the reference's ``ACTIVATION_SPEC`` pins it with
#: ``with_sharding_constraint``. None (serving, training): nothing is done.
ACTIVATION_SPEC = None


def _constrain(x):
    if ACTIVATION_SPEC is not None and x.dim() == 3:
        return x.redistribute(placements=ACTIVATION_SPEC)
    return x


def _gather_seq(h):
    """A normed (B, S, D) input of the projections with its sequence
    gathered (Megatron sequence parallelism: the residual stream stays
    sequence-sharded, the column-parallel products take whole rows)."""
    if ACTIVATION_SPEC is None or h.dim() != 3:
        return h
    from torch.distributed.tensor import Replicate
    return h.redistribute(placements=[Replicate() if p.is_shard(1) else p
                                      for p in h.placements])


def _gathered(tree):
    """The dry run's FSDP: a layer's weights (or a table) with their
    ``data``-axis shards all-gathered just before use, tensor-parallel
    shards kept; the backward reduce-scatters the gradients. Without the
    hook: the tree as it is."""
    if ACTIVATION_SPEC is None:
        return tree
    from torch.distributed.tensor import Replicate

    def one(t):
        names = t.device_mesh.mesh_dim_names
        pl = [Replicate() if names[i] in ("pod", "data") else p
              for i, p in enumerate(t.placements)]
        return t if pl == list(t.placements) else t.redistribute(
            placements=pl)
    return tree_map(one, tree)


def _whole_layers(t):
    """A stacked leaf with its layer axis gathered where a rule sharded it
    (the dry run's DTensors): no rule may select a layer out of a shard."""
    if not is_dtensor(t) or not any(p.is_shard(0) for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate
    return t.redistribute(placements=[Replicate() if p.is_shard(0) else p
                                      for p in t.placements])


def _group_structure(cfg: ModelConfig):
    pat = cfg.layer_pattern
    n_full = cfg.n_layers // len(pat)
    tail = tuple(pat[: cfg.n_layers % len(pat)])
    return pat, n_full, tail


def _check_supported(cfg: ModelConfig) -> None:
    """The reference builds every layer kind it knows and refuses any
    other (``ValueError(kind)``)."""
    for kind in cfg.layer_pattern:
        if kind not in _KINDS:
            raise ValueError(kind)


def _check_paged(cfg: ModelConfig) -> None:
    """A paged cache holds global-attention KV only (the reference's
    ``attn_apply`` refuses a paged sliding-window layer)."""
    if any(k != ATTN for k in cfg.layer_pattern):
        raise NotImplementedError("paged cache requires global attention")


# ======================================================================
# init


class _Init:
    """Seeded truncated-normal init on the device, one generator per model.

    Same tree keys, shapes and leaf dtypes as ``repro.models.init_params``
    (a few leaves stay fp32 under a bf16 config: the MoE router, SSD's
    ``A_log``/``dt_bias``/``D``, RG-LRU's ``b_a``/``b_i``/``lam``). torch
    cannot reproduce ``jax.random``'s numbers; parity tests carry the
    reference's weights across with ``repro_torch.params.params_from_numpy``.
    With several seeds every leaf gets a leading model axis, filled model by
    model (and layer by layer) so no full-size fp32 temporary is ever
    made. With ``draw=False`` no number is drawn or written: every leaf is
    an empty tensor of its shape and dtype (on the meta device, the
    counterpart of ``jax.eval_shape(init_params)``)."""

    def __init__(self, seeds, device, dtype, stacked: bool,
                 draw: bool = True):
        self.gens = [torch.Generator(device=device).manual_seed(int(s))
                     for s in seeds] if draw else []
        self.n = len(seeds)
        self.device, self.dtype, self.stacked = device, dtype, stacked

    def _fill(self, shape, fn, layers: int = 0, dtype=None):
        lead = (self.n,) if self.stacked else ()
        shape = ((layers,) if layers else ()) + tuple(shape)
        out = torch.empty(lead + shape, dtype=dtype or self.dtype,
                          device=self.device)
        for m, g in enumerate(self.gens):
            fn(out[m] if self.stacked else out, g)
        return out

    def dense(self, shape, scale=None, layers: int = 0, dtype=None):
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
        return self._fill(shape, fn, layers, dtype)

    def zeros(self, shape, layers: int = 0, dtype=None):
        return self._fill(shape, lambda t, g: t.zero_(), layers, dtype)

    def full(self, shape, value: float, layers: int = 0, dtype=None):
        return self._fill(shape, lambda t, g: t.fill_(value), layers, dtype)

    def const(self, values, layers: int = 0, dtype=None):
        """Every layer (and model) holds ``values`` (a 1-D tensor)."""
        v = torch.as_tensor(values)
        return self._fill(tuple(v.shape),
                          lambda t, g: t.copy_(v.to(t.device, t.dtype)),
                          layers, dtype)


def _layer_init(ini: _Init, cfg: ModelConfig, kind: str = ATTN, *,
                cross: bool = False, layers: int = 0):
    d = cfg.d_model
    p = {"norm1": ini.zeros((d,), layers=layers)}
    if kind in (ATTN, LOCAL_ATTN):
        p["attn"] = attn_mod.attn_init(ini, cfg, layers=layers)
    elif kind == RGLRU:
        p["rglru"] = rglru_mod.rglru_init(ini, cfg, layers=layers)
    elif kind == SSD:
        p["ssd"] = ssd_mod.ssd_init(ini, cfg, layers=layers)
    if cross:
        p["norm_x"] = ini.zeros((d,), layers=layers)
        p["cross"] = attn_mod.attn_init(ini, cfg, cross=True, layers=layers)
    if cfg.d_ff > 0 and kind != SSD:
        p["norm2"] = ini.zeros((d,), layers=layers)
        if cfg.is_moe and kind in (ATTN, LOCAL_ATTN):
            p["moe"] = moe_mod.moe_init(ini, cfg, layers=layers)
        else:
            p["mlp"] = {"wi": ini.dense((d, cfg.d_ff), layers=layers),
                        "wu": ini.dense((d, cfg.d_ff), layers=layers),
                        "wo": ini.dense((cfg.d_ff, d), layers=layers)}
    return p


def _init_tree(cfg: ModelConfig, ini: _Init):
    _check_supported(cfg)
    pat, n_full, tail = _group_structure(cfg)
    cross = cfg.is_encdec
    params = {
        "embed": ini.dense((cfg.vocab_size, cfg.d_model), scale=0.02),
        "final_norm": ini.zeros((cfg.d_model,)),
        "groups": {f"pos{i}": _layer_init(ini, cfg, kind, cross=cross,
                                          layers=n_full)
                   for i, kind in enumerate(pat)} if n_full else {},
        "tail": [_layer_init(ini, cfg, kind, cross=cross) for kind in tail],
    }
    if not cfg.tie_embeddings:
        params["unembed"] = ini.dense((cfg.vocab_size, cfg.d_model),
                                      scale=0.02)
    if cfg.is_encdec:
        params["encoder"] = {
            "groups": _layer_init(ini, cfg, ATTN, layers=cfg.encoder_layers),
            "norm": ini.zeros((cfg.d_model,))}
    return params


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random weights from a seeded generator on ``device`` (the card by
    default)."""
    dev = resolve_device(device)
    return _init_tree(cfg, _Init([seed], dev, torch_dtype(cfg.dtype), False))


def param_shapes(cfg: ModelConfig):
    """``init_params``' tree with no number drawn: every leaf an empty
    tensor on the meta device, of the leaf's shape and dtype."""
    return _init_tree(cfg, _Init([0], torch.device("meta"),
                                 torch_dtype(cfg.dtype), False, draw=False))


def init_stacked_params(cfg: ModelConfig, seeds, device=None):
    """``init_params`` for several models at once, every leaf stacked on a
    leading model axis: leaf ``[m]`` equals ``init_params(cfg, seeds[m])``'s.
    The fused decode plane stacks its decoders this way; building the stack
    directly needs no second copy of the weights
    (``core.lora.unstack_params`` gives the per-model views)."""
    dev = resolve_device(device)
    return _init_tree(cfg, _Init(seeds, dev, torch_dtype(cfg.dtype), True))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None, *,
               enc_len: int = 0, dtype=None):
    """Dense working cache: stacked groups plus tail layers. An attention
    layer holds ``{"k", "v": (batch, t, Hkv * D), "kpos": (batch, t)}``
    (``kpos = -1`` for unwritten slots; ``t = cache_len``, or the window
    for a sliding-window layer), an RG-LRU layer ``{"h", "conv"}``, an SSD
    layer ``{"ssm", "conv"}`` (the recurrent states fp32); an enc-dec
    decoder's layers add ``"cross": {"k", "v": (batch, enc_len, Hkv * D)}``."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)
    pat, n_full, tail = _group_structure(cfg)

    def layer(kind, lead):
        if kind in (ATTN, LOCAL_ATTN):
            c = attn_mod.init_attn_cache(cfg, kind, batch, cache_len, dtype,
                                         dev, lead)
        elif kind == RGLRU:
            c = rglru_mod.init_rglru_cache(cfg, batch, dtype, dev, lead)
        else:
            c = ssd_mod.init_ssd_cache(cfg, batch, dtype, dev, lead)
        if cfg.is_encdec:
            f = cfg.n_kv_heads * cfg.head_dim
            c["cross"] = {
                "k": torch.zeros(lead + (batch, enc_len, f), dtype=dtype,
                                 device=dev),
                "v": torch.zeros(lead + (batch, enc_len, f), dtype=dtype,
                                 device=dev)}
        return c

    return {"groups": {f"pos{i}": layer(kind, (n_full,))
                       for i, kind in enumerate(pat)} if n_full else {},
            "tail": [layer(kind, ()) for kind in tail]}


# ======================================================================
# forward


def _layer_slice(tree, layer: int, axis: int):
    """Layer ``layer`` of a stacked group subtree (a view, no copy); ``axis`` is
    1 when the leaves also carry a leading model axis. None (an adapter
    tree's untargeted weight) stays None; an adapter pair keeps its type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _layer_slice(v, layer, axis) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_layer_slice(v, layer, axis) for v in tree))
    return _whole_layers(tree).select(axis, layer)


def _cache_slice(cache, layer: int):
    """Layer ``layer`` of a stacked group cache (views, so in-place updates
    reach the stack): dense leaves are stacked, a paged cache shares one
    block table across layers."""
    if "k_pages" in cache:
        return {"k_pages": cache["k_pages"][layer], "v_pages": cache["v_pages"][layer],
                "block_tables": cache["block_tables"]}
    return _layer_slice(cache, layer, 0)


def _store(cache, new) -> None:
    """Write a recurrent block's new state into its cache, in place."""
    for key, val in new.items():
        cache[key].copy_(val)


def _apply_layer(lp, x, cfg, kind, cache, pos, enc_out=None,
                 inplace: bool = True):
    """One layer. Returns (x, MoE aux or {}, cache): the cache updated in
    place, or with ``inplace=False`` (the functional path) a new layer
    cache dict of new tensors, nothing written."""
    lp = _gathered(lp)
    x = _constrain(x)
    h = _gather_seq(rmsnorm(x, lp["norm1"], cfg.norm_eps))
    aux = {}
    if kind in (ATTN, LOCAL_ATTN):
        out, c = attn_mod.attn_apply(lp["attn"], h, cfg, kind, cache=cache,
                                     pos=pos, inplace=inplace)
    elif kind == RGLRU:
        out, c = rglru_mod.rglru_apply(lp["rglru"], h, cfg, cache=cache)
    elif kind == SSD:
        out, c = ssd_mod.ssd_apply(lp["ssd"], h, cfg, cache=cache)
    else:
        raise ValueError(kind)
    if cache is not None and not inplace:
        cache = {**cache, **c}
    elif cache is not None and kind in (RGLRU, SSD):
        _store(cache, c)
    x = x + _constrain(out)       # explicit: its backward gathers, too
    if "cross" in lp:
        # prefill (enc_out given) writes the cross cache, decode reads it
        hx = _gather_seq(rmsnorm(x, lp["norm_x"], cfg.norm_eps))
        out, cc = attn_mod.attn_apply(
            lp["cross"], hx, cfg, ATTN, enc_out=enc_out, cross=True,
            cache=cache.get("cross") if cache is not None else None,
            inplace=inplace)
        x = x + _constrain(out)
        if cache is not None and not inplace:
            cache["cross"] = cc
    if "norm2" in lp:
        h2 = _gather_seq(rmsnorm(x, lp["norm2"], cfg.norm_eps))
        if "moe" in lp:
            out2, aux = moe_mod.moe_apply(lp["moe"], h2, cfg)
        else:
            out2 = mlp_apply(lp["mlp"], h2)
        x = x + _constrain(out2)
    return x, aux, cache


def _aux_zero(device):
    return {"lb_loss": torch.zeros((), dtype=torch.float32, device=device),
            "dropped_frac": torch.zeros((), dtype=torch.float32,
                                        device=device)}


def _kinds(cfg):
    """Layer kinds in ``_layers``' execution order."""
    pat, n_full, tail = _group_structure(cfg)
    return list(pat) * n_full + list(tail)


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


def _unbind(tree, n: int) -> list:
    """The ``n`` layers of a stacked group subtree, one ``unbind`` per leaf:
    its backward stacks all layers' gradients in one op, where each
    layer's ``select`` would add a zero-filled tensor of the whole stack."""
    if isinstance(tree, dict):
        parts = {k: _unbind(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return list(_whole_layers(tree).unbind(0))


def _add_aux(aux, ax) -> None:
    for k in ax:
        aux[k] = aux[k] + ax[k]


def recording(*trees) -> bool:
    """True when autograd records through a forward over ``trees`` (params,
    caches, input embeddings): grad mode is on and some leaf requires a
    gradient. Then the forward takes the functional cache path."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for tree in trees for t in tree_leaves(tree))


def _group(cfg, kinds, pos, enc_out, x, lps, lcs):
    """One repetition of the layer pattern on the functional path: returns
    (x, the layers' new caches, summed aux)."""
    aux, new = _aux_zero(x.device), []
    for lp, lc, kind in zip(lps, lcs, kinds):
        x, ax, nc = _apply_layer(lp, x, cfg, kind, lc, pos, enc_out,
                                 inplace=False)
        _add_aux(aux, ax)
        new.append(nc)
    return x, new, aux


def _functional_layers(cfg, params, x, cache, pos, enc_out, remat):
    """Every layer on the functional path (no tensor is written in place):
    stacked weights and caches are unbound once, each group of
    ``layer_pattern`` layers runs under ``torch.utils.checkpoint`` when
    ``remat`` (the reference's ``jax.checkpoint(group_body)``: memory, not
    values), and the layers' new caches are stacked back into the
    reference's layout. Returns (x, new cache or None, aux)."""
    if cache is not None and any("k_pages" in c for c in (
            *cache["groups"].values(), *cache["tail"])):
        raise NotImplementedError(
            "the paged pool is written in place; differentiate through a "
            "dense cache")
    pat, n_full, tail = _group_structure(cfg)
    aux = _aux_zero(x.device)
    new_groups = {}
    if n_full:
        gp = [_unbind(params["groups"][f"pos{i}"], n_full)
              for i in range(len(pat))]
        gc = None if cache is None else [
            _unbind(cache["groups"][f"pos{i}"], n_full)
            for i in range(len(pat))]
        outs = []
        for layer in range(n_full):
            lps = [g[layer] for g in gp]
            lcs = [None] * len(pat) if gc is None else [g[layer] for g in gc]
            args = (cfg, pat, pos, enc_out, x, lps, lcs)
            x, nc, ax = (checkpoint(_group, *args, use_reentrant=False)
                         if remat else _group(*args))
            _add_aux(aux, ax)
            outs.append(nc)
        if cache is not None:
            new_groups = {f"pos{i}": tree_map(lambda *xs: torch.stack(xs),
                                              *(o[i] for o in outs))
                          for i in range(len(pat))}
    new_tail = []
    for i, kind in enumerate(tail):
        x, ax, nc = _apply_layer(
            params["tail"][i], x, cfg, kind,
            None if cache is None else cache["tail"][i], pos, enc_out,
            inplace=False)
        _add_aux(aux, ax)
        new_tail.append(nc)
    new = None if cache is None else {"groups": new_groups, "tail": new_tail}
    return x, new, aux


def _embed(cfg, table, index, host_scale: bool = False):
    """Embedding rows times sqrt(d), in the model dtype (the reference's
    ``jnp.asarray(sqrt(d), dtype)``). ``index`` is a token tensor, or a
    (model ids, tokens) pair for a stacked table. ``host_scale``: the
    scale as a 0-dim host tensor, which a product on the card takes as a
    kernel argument, with no copy to the card (a CUDA-graph capture allows
    none); the same numbers."""
    rows = table[index] if isinstance(index, tuple) else embed_lookup(table,
                                                                      index)
    return rows * torch.tensor(
        cfg.d_model ** 0.5, dtype=table.dtype,
        device="cpu" if host_scale else table.device)


def encode(cfg: ModelConfig, params, embeds):
    """Bidirectional encoder over precomputed frame embeddings (the audio
    frontend is a stub): (B, T, D) -> (B, T, D)."""
    x = embeds.to(torch_dtype(cfg.dtype))
    enc = params["encoder"]
    for lp in map(_gathered, _unbind(enc["groups"], cfg.encoder_layers)):
        x = _constrain(x)
        h = _gather_seq(rmsnorm(x, lp["norm1"], cfg.norm_eps))
        # bidirectional: all positions valid for all queries
        out, _ = attn_mod.attn_apply(lp["attn"], h, cfg, ATTN, causal=False)
        x = x + _constrain(out)
        x = x + _constrain(mlp_apply(lp["mlp"], _gather_seq(
            rmsnorm(x, lp["norm2"], cfg.norm_eps))))
    return _gather_seq(rmsnorm(x, enc["norm"], cfg.norm_eps))


def forward(cfg: ModelConfig, params, tokens, *, cache=None, pos=None,
            prefix_embeds=None, enc_out=None, logits: str = "last",
            remat: bool = False):
    """Run the decoder stack. tokens: (B, S) int; pos: (B,) int32 absolute
    position of the first input row (None -> zeros). ``prefix_embeds``
    (B, P, D): a mixed-input model prepends them to the token embeddings,
    an embeds-input decoder-only model runs on them alone; ``enc_out``: the
    encoder output an enc-dec decoder cross-attends to (prefill; decode
    reads the cross cache). Returns (output, cache, aux): last-row logits
    (B, V), all logits (B, S, V) or hidden states (B, S, D) for ``logits``
    in {"last", "all", "hidden"}; aux holds the MoE layers' summed
    ``lb_loss`` and ``dropped_frac`` (zeros without MoE layers).

    Serving (no autograd recording): a cache, dense or paged, is updated
    in place and returned. While autograd records (``recording``: grad mode
    on and some parameter, cache or input tensor requires a gradient) the
    forward is functional: every layer makes new cache tensors, the
    returned cache is a new tree in the reference's layout (each group's
    layers stacked) and the given one is left as it was; ``remat=True``
    then recomputes each ``layer_pattern`` group in the backward
    (``torch.utils.checkpoint``), which changes memory, never values."""
    _check_supported(cfg)
    dtype = torch_dtype(cfg.dtype)
    if cfg.input_mode == "mixed" and prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(dtype),
                       _embed(cfg, _gathered(params["embed"]), tokens)],
                      dim=1)
    elif cfg.input_mode == "embeds" and prefix_embeds is not None \
            and not cfg.is_encdec:
        x = prefix_embeds.to(dtype)
    else:
        x = _embed(cfg, _gathered(params["embed"]), tokens)
    if pos is None:
        pos = torch.zeros((x.shape[0],), dtype=torch.int32, device=x.device)
    if recording(params, cache, prefix_embeds, enc_out):
        x, cache, aux = _functional_layers(cfg, params, x, cache, pos,
                                           enc_out, remat)
    else:
        aux = _aux_zero(x.device)
        for (lp, lc), kind in zip(_layers(cfg, params, cache), _kinds(cfg)):
            x, ax, _ = _apply_layer(lp, x, cfg, kind, lc, pos, enc_out)
            _add_aux(aux, ax)
    x = _gather_seq(rmsnorm(x, params["final_norm"], cfg.norm_eps))
    table = _gathered(params.get("unembed", params["embed"]))
    if logits == "hidden":
        out = x
    elif logits == "all":
        out = unembed(x, table, cfg.final_softcap)
    else:
        out = unembed(x[:, -1], table, cfg.final_softcap)
    return out, cache, aux


def decode_stacked(cfg: ModelConfig, stacked, tokens, pos, k_layers,
                   v_layers, block_tables, rows=None, lanes=None):
    """The fused decode plane's step: ONE forward for M stacked decoders.

    stacked: a param tree whose every leaf has a leading model axis M; or,
    with ``lanes`` given (a LoRA group), ``{"base": tree, "ab": adapters}``:
    the base tree has no model axis and every lane reads it, the adapters
    are stacked on M, and ``lanes(layer params, layer adapters)`` gives each
    layer's weights for the M lanes just before the layer runs
    (``core.lora.lora_lanes``), so merged weights exist one layer at a time.
    tokens, pos: (M, Bmax) int (row (m, b) feeds decoder m; padding rows
    carry pos 0 and a block table of sentinel page 0). k/v_layers: each
    layer's (P, page, Hkv, D) pool pages in execution order, shared by all
    models. block_tables: (M * Bmax, npages) int32. rows: None when every
    row is real, else an integer device tensor of flat indices m * Bmax + b
    (``attention.paged_decode_rows``): only those rows write the pool; the
    fused plane passes M * Bmax of them, the real rows' and then repeats of
    the first. Nothing in the step copies from the host, so a CUDA graph
    can capture it (``serving.decode``). Projections and MLPs are
    batched matrix products over the model axis; attention is one
    ``paged_decode`` launch per layer over all M * Bmax rows, each real row
    writing its K/V straight into the shared pool. An MoE layer routes each
    (model, row) token alone (S = 1, so its capacity is 1 and nothing is
    dropped). Returns (M, Bmax, V) fp32 logits."""
    _check_paged(cfg)
    M, Bmax = tokens.shape
    if lanes is None:
        top = stacked
        mid = torch.arange(M, device=tokens.device)[:, None]
        x = _embed(cfg, top["embed"], (mid, tokens.long()),   # (M, Bmax, d)
                   host_scale=True)
        layers = ((lp, None) for lp, _ in _layers(cfg, stacked, None, axis=1))
    else:
        top = stacked["base"]                # untargeted: the one base copy
        x = _embed(cfg, top["embed"], tokens, host_scale=True)
        layers = ((lp, ab) for (lp, _), (ab, _) in zip(
            _layers(cfg, top, None), _layers(cfg, stacked["ab"], None,
                                             axis=1)))
    flat_pos = pos.reshape(-1)
    hq, hd = cfg.n_heads, cfg.head_dim
    for (lp, ab), kp, vp in zip(layers, k_layers, v_layers):
        if lanes is not None:
            lp = lanes(lp, ab)     # this layer's merged lanes, dropped below
        ap = lp["attn"]
        h = rmsnorm(x, lp["norm1"], cfg.norm_eps)
        q, k, v = attn_mod.project_qkv(ap, h, cfg, pos)       # (M, Bmax, H, D)
        o = attn_mod.paged_decode_rows(
            q.reshape(M * Bmax, hq, hd), k.reshape(M * Bmax, -1, hd),
            v.reshape(M * Bmax, -1, hd), kp, vp, block_tables, flat_pos,
            softcap=cfg.attn_softcap, rows=rows)
        x = x + o.reshape(M, Bmax, hq * hd) @ ap["wo"]
        if "norm2" in lp:
            h2 = rmsnorm(x, lp["norm2"], cfg.norm_eps)
            if "moe" in lp:      # (M, Bmax, 1, d): one routing row per token
                x = x + moe_mod.moe_apply(lp["moe"], h2[:, :, None],
                                          cfg)[0][:, :, 0]
            else:
                x = x + mlp_apply(lp["mlp"], h2)
        del lp, ap          # before the next layer merges its own lanes
    x = rmsnorm(x, top["final_norm"], cfg.norm_eps)
    table = top.get("unembed", top["embed"])
    return unembed(x, table, cfg.final_softcap)


# ======================================================================
# losses


def _chunk_nll(h, table, t, m, softcap):
    """One CE chunk: (sum of masked NLL, sum of the mask); under
    ``torch.utils.checkpoint`` the (B, c, V) logits are recomputed in the
    backward, never kept."""
    if is_dtensor(h):
        return _sharded_chunk_nll(h, table, t, m, softcap)
    logits = unembed(h, table, softcap)                        # (B,c,V) f32
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, t.long()[..., None])[..., 0]
    return ((lse - picked) * m).sum(), m.sum()


def _sharded_chunk_nll(h, table, t, m, softcap):
    """``_chunk_nll`` on the dry run's DTensors. The chunk's rows ``h`` are
    batch-only (``forward`` gathered the sequence) and meet the table's
    ``model`` shard: a table sharded on its features (a vocabulary the
    axis does not divide) takes ``h``'s features sliced alike, so the
    logits are partial sums and no product is repeated on every rank. The
    logits keep their forward layout in the backward too (``pin_grad``):
    the unembedding's products flatten (B, c), and a gradient sharded on c
    by ``model`` would give that dim three mesh shards on a (pod, data,
    model) mesh. Reduced over the vocab with (B, c) all-reduces, never
    gathered: logsumexp by its max and sum, the target's logit by a masked
    sum (one term, the rest exact zeros; DTensor cannot reduce a gather's
    masked partial here)."""
    from torch.distributed.tensor import Replicate, Shard
    ax = table.device_mesh.mesh_dim_names.index("model")
    if table.placements[ax] == Shard(1):
        pl = list(h.placements)
        pl[ax] = Shard(2)
        h = h.redistribute(placements=pl)
    logits = pin_grad(unembed(h, table, softcap))              # (B,c,V) f32

    def whole(x):             # a vocab reduction's partials, summed
        return x.redistribute(placements=[
            Replicate() if p.is_partial() else p for p in x.placements])
    mx = whole(logits.detach().amax(-1, keepdim=True))
    lse = (mx + torch.log(whole(torch.exp(logits - mx).sum(
        -1, keepdim=True))))[..., 0]
    hit = torch.arange(logits.shape[-1], device=t.device) == \
        t.long()[..., None]
    picked = whole(torch.where(hit, logits, 0.0).sum(-1))
    return ((lse - picked) * m).sum(), m.sum()


def train_loss(cfg: ModelConfig, params, tokens, targets, mask, *,
               prefix_embeds=None, enc_embeds=None, remat: bool = True,
               ce_chunk: int = 512, lb_coeff: float = 0.01):
    """Next-token CE over ``targets`` (B, S) weighted by ``mask`` (B, S),
    with the unembedding taken ``ce_chunk`` rows at a time (the reference's
    ``while S % c: c -= 1``), each chunk checkpointed so no (B, S, V) logits
    are stored. A mixed-input model's prefix rows are stripped first; an
    enc-dec model encodes ``enc_embeds``; an MoE model adds ``lb_coeff``
    times the load-balancing loss. Returns (loss, aux)."""
    enc_out = None
    if cfg.is_encdec:
        enc_out = encode(cfg, params, enc_embeds)
    hidden, _, aux = forward(cfg, params, tokens, prefix_embeds=prefix_embeds,
                             enc_out=enc_out, logits="hidden", remat=remat)
    if cfg.input_mode == "mixed" and prefix_embeds is not None:
        hidden = hidden[:, prefix_embeds.shape[1]:]
    table = _gathered(params.get("unembed", params["embed"]))
    S = hidden.shape[1]
    c = ce_chunk
    while S % c:
        c -= 1
    nlls, counts = [], []
    for i in range(0, S, c):
        args = (hidden[:, i:i + c], table, targets[:, i:i + c],
                mask[:, i:i + c], cfg.final_softcap)
        nll, cnt = checkpoint(_chunk_nll, *args, use_reentrant=False)
        nlls.append(nll)
        counts.append(cnt)
    loss = torch.stack(nlls).sum() / torch.clamp(torch.stack(counts).sum(),
                                                 min=1.0)
    if cfg.is_moe:
        loss = loss + lb_coeff * aux["lb_loss"]
    return loss, aux
