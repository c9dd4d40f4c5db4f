"""Analytic FLOP / device-memory-byte model per (arch x input shape).

Port of ``repro.launch.analytic`` (copied; pure Python over the configs'
``INPUT_SHAPES`` and ``kvcache/manager``). The reference derives its
roofline's compute and memory terms here because a compiled program's cost
analysis counts a loop body once; its collective term and per-chip memory
come from the reference's HLO parse and dry-run compiles
(``repro.launch.hloanalysis``, ``repro.launch.dryrun``), which are not
ported yet.

Conventions:
  MODEL_FLOPS = 6·N_active·tokens (train) or 2·N_active·tokens (inference) —
  the "useful" figure. flops/bytes below include attention/SSD terms, the
  CE/unembed matmul, remat recompute, and optimizer traffic, so
  MODEL_FLOPS / flops shows the structural overhead.
"""
from __future__ import annotations

from repro_torch.configs.base import (ATTN, LOCAL_ATTN, SSD, INPUT_SHAPES,
                                      ModelConfig)
from repro_torch.kvcache.manager import kv_bytes_per_token, state_bytes_per_seq

SSD_CHUNK = 64
FLASH_QCHUNK = 1024


def _attn_flops(cfg: ModelConfig, n_q: int, kv_len: int, batch: int,
                causal: bool) -> float:
    total = 0.0
    for kind in cfg.layer_kinds():
        if kind == ATTN:
            t = kv_len
        elif kind == LOCAL_ATTN:
            t = min(kv_len, cfg.sliding_window or kv_len)
        else:
            continue
        f = 4.0 * batch * n_q * t * cfg.n_heads * cfg.head_dim
        if causal and n_q == kv_len and kind == ATTN:
            f *= 0.5
        total += f
    if cfg.is_encdec:
        # decoder cross-attention over enc_len (= kv_len here) + encoder self
        total += 4.0 * batch * n_q * kv_len * cfg.n_heads * cfg.head_dim * cfg.n_layers / max(
            len(cfg.layer_kinds()), 1)
    return total


def _ssd_flops(cfg: ModelConfig, n_tokens: int, batch: int) -> float:
    if SSD not in cfg.layer_pattern:
        return 0.0
    d_in = cfg.ssm_expand * cfg.d_model
    nh = d_in // cfg.ssm_head_dim
    P, N, Q = cfg.ssm_head_dim, cfg.ssm_state, SSD_CHUNK
    n_ssd = sum(1 for k in cfg.layer_kinds() if k == SSD)
    per_tok = (2 * Q * N                 # intra-chunk scores C·B^T
               + 2 * Q * nh * P / max(nh, 1) * nh  # y_diag (Q per token)
               + 4 * nh * P * N)         # state update + y_off
    return float(n_ssd * batch * n_tokens * per_tok)


def _unembed_flops(cfg: ModelConfig, n_tokens: int, batch: int) -> float:
    return 2.0 * batch * n_tokens * cfg.vocab_size * cfg.d_model


def step_analytic(cfg: ModelConfig, shape_name: str) -> dict:
    shp = INPUT_SHAPES[shape_name]
    B, S = shp.global_batch, shp.seq_len
    db = 2  # bf16
    n_act = cfg.active_param_count()
    n_tot = cfg.param_count()
    npfx = cfg.n_prefix_embeds if cfg.input_mode == "mixed" else 0
    dec_len = S // 2 if cfg.is_encdec else S - npfx
    enc_len = S // 2 if cfg.is_encdec else 0
    kvt = kv_bytes_per_token(cfg, db)
    sps = state_bytes_per_seq(cfg)
    L, D = cfg.n_layers, cfg.d_model

    if shp.kind == "train":
        toks = dec_len + enc_len + npfx
        fwd = (2.0 * n_act * toks * B + _attn_flops(cfg, dec_len, dec_len, B, True)
               + _ssd_flops(cfg, dec_len, B) + _unembed_flops(cfg, dec_len, B))
        flops = 4.0 * fwd                       # fwd + bwd(2x) + remat re-fwd
        model_flops = 6.0 * n_act * toks * B
        bytes_ = (n_tot * db * 3                # weights: fwd, bwd, update
                  + n_tot * 2 * 2 * 2           # bf16 moments read+write x2
                  + n_tot * db * 2              # grads w + params rw
                  + 4.0 * L * B * dec_len * D * db)  # checkpointed activations
    elif shp.kind == "prefill":
        toks = dec_len + enc_len + npfx
        fwd_q = dec_len + npfx
        flops = (2.0 * n_act * toks * B
                 + _attn_flops(cfg, fwd_q, fwd_q, B, True)
                 + _ssd_flops(cfg, fwd_q, B)
                 + _unembed_flops(cfg, 1, B))
        model_flops = 2.0 * n_act * toks * B
        n_attn = sum(1 for k in cfg.layer_kinds() if k in (ATTN, LOCAL_ATTN))
        flash_reads = (fwd_q / FLASH_QCHUNK) * fwd_q * (
            kvt / max(n_attn, 1)) * n_attn * B if n_attn else 0
        bytes_ = (n_tot * db + B * toks * kvt + B * sps
                  + 2.0 * L * B * fwd_q * D * db + flash_reads)
    else:  # decode
        kv_len = S // 2 if cfg.is_encdec else S
        flops = (2.0 * n_act * B
                 + _attn_flops(cfg, 1, kv_len, B, False)
                 + _ssd_flops(cfg, 1, B)
                 + _unembed_flops(cfg, 1, B))
        model_flops = 2.0 * n_act * B
        eff_kv = 0
        for kind in cfg.layer_kinds():
            if kind == ATTN:
                eff_kv += kv_len
            elif kind == LOCAL_ATTN:
                eff_kv += min(kv_len, cfg.sliding_window or kv_len)
        per_layer_kv = kvt / max(
            sum(1 for k in cfg.layer_kinds() if k in (ATTN, LOCAL_ATTN)), 1)
        bytes_ = (n_tot * db + B * eff_kv * per_layer_kv + B * sps
                  + 2.0 * L * B * D * db)
    return {"flops": float(flops), "hbm_bytes": float(bytes_),
            "model_flops": float(model_flops)}
