"""Step functions and their inputs for every (arch x input shape) combo.

Port of ``repro.launch.steps``. Shapes (``configs.base.INPUT_SHAPES``):
  train_4k     -> train step   (forward + backward + AdamW, remat, chunked CE)
  prefill_32k  -> prefill step (fill a cache of seq_len)
  decode_32k   -> serve step   (ONE token against a seq_len cache)
  long_500k    -> serve step   (batch 1, a half-megatoken cache)

Modality conventions, as in the reference: audio (enc-dec) splits seq_len
50/50 into encoder frames and decoder tokens; a vlm takes
``n_prefix_embeds`` patch embeddings plus ``seq_len - n_prefix`` text
tokens.

``build`` returns shape-only arguments, no number drawn: meta tensors for
one device (the counterpart of ``jax.ShapeDtypeStruct``; ``materialize``
makes real ones of the same shapes and dtypes), or, given a mesh, the
placements ``launch/dryrun.py`` lays fake DTensors out with. The reference
donates the buffers a step rewrites; here the step rewrites them in place
(the train step copies its new params and moments into the given tensors,
the serve and prefill steps write the cache), and ``donate`` lists them.
"""
from __future__ import annotations

import math
import os

import torch

from repro_torch.configs.base import (ATTN, INPUT_SHAPES, LOCAL_ATTN,
                                      ModelConfig)
from repro_torch.device import torch_dtype
from repro_torch.launch.mesh import axis_size, data_axes
from repro_torch.launch.sharding import (batch_sharding, cache_shardings,
                                         params_shardings, placements)
from repro_torch.models import attention as attn_mod
from repro_torch.models import model as model_mod
from repro_torch.models.model import (encode, forward, init_cache,
                                      init_params, param_shapes, train_loss)
from repro_torch.params import tree_leaves
from repro_torch.training.optim import AdamW
from repro_torch.training.trainer import Trainer

# ======================================================================
# step functions


def make_train_step(cfg: ModelConfig, opt: AdamW):
    """(params, opt_state, batch) -> (params, opt_state, loss): one
    ``train_loss(remat=True)`` step and its AdamW update, the new params and
    moments copied into the given tensors."""
    def loss_fn(p, tokens, targets, mask, prefix_embeds=None,
                enc_embeds=None):
        return train_loss(cfg, p, tokens, targets, mask,
                          prefix_embeds=prefix_embeds,
                          enc_embeds=enc_embeds, remat=True)

    trainer = Trainer(loss_fn, opt)

    def step(params, opt_state, batch):
        new_params, new_state, loss = trainer.step(params, opt_state, batch)
        with torch.no_grad():
            for dst, src in zip(tree_leaves((params, opt_state)),
                                tree_leaves((new_params, new_state))):
                dst.copy_(src)
        return params, opt_state, loss
    return step


def make_prefill_step(cfg: ModelConfig):
    @torch.no_grad()
    def step(params, tokens, cache, pos, prefix_embeds=None,
             enc_embeds=None):
        enc_out = None
        if cfg.is_encdec and enc_embeds is not None:
            enc_out = encode(cfg, params, enc_embeds)
        logits, cache, _ = forward(cfg, params, tokens, cache=cache, pos=pos,
                                   prefix_embeds=prefix_embeds,
                                   enc_out=enc_out)
        return logits, cache
    return step


def make_serve_step(cfg: ModelConfig):
    @torch.no_grad()
    def step(params, token, cache, pos):
        logits, cache, _ = forward(cfg, params, token, cache=cache, pos=pos)
        return logits, cache
    return step


# ======================================================================
# inputs


def param_structs(cfg: ModelConfig):
    """The parameter tree as meta tensors (``jax.eval_shape`` of
    ``init_params``)."""
    return param_shapes(cfg)


def _dims(cfg: ModelConfig, shp):
    """(B, prefix rows, encoder frames, decoder tokens, cache length)."""
    B, S = shp.global_batch, shp.seq_len
    npfx = cfg.n_prefix_embeds if cfg.input_mode == "mixed" else 0
    enc_len = S // 2 if cfg.is_encdec else 0
    dec_len = S // 2 if cfg.is_encdec else S - npfx
    cache_len = (dec_len + npfx) if shp.kind == "prefill" else (
        S // 2 if cfg.is_encdec else S)
    return B, npfx, enc_len, dec_len, cache_len


def _arguments(cfg: ModelConfig, shp, device, params, moment_dtype, fill):
    """The step's positional arguments on ``device``; ``fill(kind, shape,
    dtype)`` makes each input tensor ("tokens", "mask", "embeds", "pos")."""
    B, npfx, enc_len, dec_len, cache_len = _dims(cfg, shp)
    dt = torch_dtype(cfg.dtype)
    if shp.kind == "train":
        opt = AdamW(1e-4, moment_dtype=moment_dtype, weight_decay=0.1)
        batch = {"tokens": fill("tokens", (B, dec_len), torch.int32),
                 "targets": fill("tokens", (B, dec_len), torch.int32),
                 "mask": fill("mask", (B, dec_len), torch.float32)}
        if npfx:
            batch["prefix_embeds"] = fill("embeds", (B, npfx, cfg.d_model),
                                          dt)
        if cfg.is_encdec:
            batch["enc_embeds"] = fill("embeds", (B, enc_len, cfg.d_model),
                                       dt)
        return (params, opt.init(params), batch), opt
    cache = init_cache(cfg, B, int(cache_len), device, enc_len=enc_len)
    if shp.kind == "prefill":
        args = [params, fill("tokens", (B, dec_len), torch.int32), cache,
                fill("pos0", (B,), torch.int32)]
        if npfx:
            args.append(fill("embeds", (B, npfx, cfg.d_model), dt))
        elif cfg.is_encdec:
            args.append(None)
        if cfg.is_encdec:
            args.append(fill("embeds", (B, enc_len, cfg.d_model), dt))
        return tuple(args), None
    return (params, fill("tokens", (B, 1), torch.int32), cache,
            fill("pos", (B,), torch.int32)), None


def set_hooks(activation=None, flash_kv=None) -> None:
    """Set the models' two sharding hooks; with no argument, clear them."""
    model_mod.ACTIVATION_SPEC, attn_mod.FLASH_KV_SPEC = activation, flash_kv


def _hook_specs(cfg: ModelConfig, shp, mesh, policy: str) -> tuple:
    """(ACTIVATION_SPEC, FLASH_KV_SPEC) for a mesh, both None without one."""
    act = flash_kv = None
    if mesh is None:
        return act, flash_kv
    # the batch on the data axes, or on ``data`` alone (each pod a copy)
    # where it does not divide them all (prefill_32k's 32 rows on a
    # (2, 32, 8) mesh), else replicated: DTensor takes no uneven view
    das = next((axes for axes in (data_axes(mesh), ("data",))
                if shp.global_batch % math.prod(
                    axis_size(mesh, a) for a in axes) == 0), None)
    if policy == "batch":
        act = placements((das, None, None), mesh)
    elif policy == "seqpar":
        act = placements((das, "model", None), mesh)
    # the flash path's K/V (B, T, Hkv, D): batch on data, heads on model
    # where they divide (prefill/train; decode's KV stays sequence-sharded)
    if shp.kind in ("prefill", "train") and policy != "none":
        heads = "model" if cfg.n_kv_heads % axis_size(mesh, "model") == 0 \
            else None
        flash_kv = placements((das, None, heads, None), mesh)
    return act, flash_kv


def build(cfg: ModelConfig, shape_name: str, mesh=None, *,
          moment_dtype=torch.bfloat16, activation_policy: str | None = None):
    """dict(fn, args, placements, donate) for one combo.

    ``args`` are meta tensors (params, optimizer state, caches, inputs):
    their shapes and dtypes are the step's, nothing is allocated.
    ``placements`` is None without a mesh, else a tree like ``args`` of
    DTensor placements (``launch/sharding.py``). ``donate`` holds the
    positions of the arguments the step rewrites in place. The activation
    policy (``REPRO_ACT_POLICY``, as in the reference): ``seqpar`` shards
    the residual stream's sequence on ``model`` (train, prefill), ``batch``
    pins the batch only (decode, and MoE, whose routing fights a sharded
    sequence), ``none`` leaves it to DTensor's propagation."""
    shp = INPUT_SHAPES[shape_name]
    default = "batch" if (shp.kind == "decode" or cfg.is_moe) else "seqpar"
    policy = activation_policy or os.environ.get("REPRO_ACT_POLICY", default)
    set_hooks(*_hook_specs(cfg, shp, mesh, policy))

    def meta(kind, shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    args, opt = _arguments(cfg, shp, torch.device("meta"), param_structs(cfg),
                           moment_dtype, meta)
    if shp.kind == "train":
        fn, donate = make_train_step(cfg, opt), (0, 1)
    else:
        fn = (make_prefill_step if shp.kind == "prefill"
              else make_serve_step)(cfg)
        donate = (2,)
    return {"fn": fn, "args": args, "donate": donate,
            "placements": None if mesh is None
            else _placements(cfg, shp, mesh, args)}


def _placements(cfg: ModelConfig, shp, mesh, args):
    """Placements like the reference's ``in_shardings``: inference is pure
    tensor parallelism (weights replicated over ``data``) while a card
    holds the tensor-parallel shard; training and larger models keep
    FSDP."""
    tp_bytes = 2 * cfg.param_count() / axis_size(mesh, "model")
    fsdp = shp.kind == "train" or tp_bytes > 10e9
    p_pl = params_shardings(args[0], mesh, fsdp=fsdp)
    if shp.kind == "train":
        return (p_pl, params_shardings(args[1], mesh),
                {k: batch_sharding(tuple(v.shape), mesh)
                 for k, v in args[2].items()})
    return tuple(
        p_pl if i == 0 else None if a is None
        else cache_shardings(a, mesh, decode=shp.kind == "decode") if i == 2
        else batch_sharding(tuple(a.shape), mesh) for i, a in enumerate(args))


# ======================================================================
# real inputs


def _fill_context(cfg: ModelConfig, cache, pos: int, gen) -> None:
    """Make a decode cache hold a context of ``pos`` tokens: random K/V
    (and cross K/V) and the positions a prefill would have left, so the
    token at ``pos`` attends over the whole cache."""
    pat, n_full, tail = model_mod._group_structure(cfg)
    nodes = [(cache["groups"][f"pos{i}"], k) for i, k in enumerate(pat)
             if n_full] + list(zip(cache["tail"], tail))
    for c, kind in nodes:
        for key in ("k", "v"):
            if key in c:
                c[key].normal_(0.0, 1.0, generator=gen)
        if "cross" in c:
            for t in c["cross"].values():
                t.normal_(0.0, 1.0, generator=gen)
        if kind in (ATTN, LOCAL_ATTN):
            t = c["kpos"].shape[-1]
            if kind == LOCAL_ATTN and cfg.sliding_window:
                # oldest to newest; the step shifts left and appends
                c["kpos"].copy_(torch.arange(pos - t, pos))
            else:
                # slot j holds position j; the step writes slot pos
                c["kpos"].copy_(torch.where(torch.arange(t) < pos,
                                            torch.arange(t), -1))


def materialize(cfg: ModelConfig, shape_name: str, device, *, params=None,
                seed: int = 0, moment_dtype=torch.bfloat16):
    """Real arguments of ``build(cfg, shape_name)``'s shapes and dtypes on
    ``device``: ``params`` (or ``init_params(cfg, seed)``), zero moments,
    random tokens and embeddings (seeded), a full mask; a prefill's cache
    empty at position 0; a decode's cache holding a context of
    ``cache_len - 1`` random keys, the token at the last slot."""
    shp = INPUT_SHAPES[shape_name]
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pos = _dims(cfg, shp)[4] - 1

    def fill(kind, shape, dtype):
        if kind == "tokens":
            return torch.randint(1, cfg.vocab_size, shape, generator=gen,
                                 device=device, dtype=dtype)
        if kind == "embeds":
            return torch.randn(shape, generator=gen, device=device,
                               dtype=dtype)
        if kind == "mask":
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.full(shape, pos if kind == "pos" else 0, dtype=dtype,
                          device=device)

    if params is None:
        params = init_params(cfg, seed, device)
    args, _ = _arguments(cfg, shp, device, params, moment_dtype, fill)
    if shp.kind == "decode":
        _fill_context(cfg, args[2], pos, gen)
    return args


def arg_bytes(tree) -> int:
    """Bytes of every tensor in a tree of arguments."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if t is not None)
