"""Analytic step-time model for prefill and decode on one NVIDIA H100.

Port of ``repro.serving.costmodel``: the same two-term roofline (compute
and device memory) per step, with the same optional calibration path that
scales the analytic terms (``from_calibration_file``, for the simulator).
The hardware figures are the H100's, never the reference's:

  - ``PEAK_FLOPS``: 989e12, dense bf16 on the tensor cores, H100 SXM
    (NVIDIA's data sheet, 700 W part);
  - ``HBM_BW``: 3.35e12 bytes/s, H100 SXM HBM3 (same sheet);
  - ``HBM_BYTES``: 80e9 bytes of device memory a card (same sheet; the
    serving simulator's per-worker budget is cards times this);
  - ``MATMUL_EFF`` and ``BW_EFF``: the sustained fractions of those peaks.
    Both are an UNMEASURED PRIOR: round numbers, not fitted to any run.
    ``chip_smoke.py`` phase 11 prints this model's prediction for a
    victim's re-prefill beside the chunk time it measured on the card
    (PERF.md), which is how far the prior is off.

The preemption subsystem prices swap against recompute with
``SwapCostModel``: the host link at its MEASURED bandwidth, the re-prefill
through ``CostModel.prefill``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

from repro_torch.configs.base import ModelConfig
from repro_torch.kvcache.manager import kv_bytes_per_token, state_bytes_per_seq

# --- NVIDIA H100 SXM, per card (data sheet, dense, 700 W) ---
PEAK_FLOPS = 989e12          # bf16 tensor cores
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9             # device memory (the 80 GB part)
# unmeasured prior: sustained fraction of the peaks above
MATMUL_EFF = 0.5
BW_EFF = 0.8


@dataclass
class StepCost:
    seconds: float
    compute_s: float
    memory_s: float
    flops: float
    bytes: float


class CostModel:
    def __init__(self, cfg: ModelConfig, *, chips: int = 1,
                 dtype_bytes: int = 2, calibration: dict | None = None):
        self.cfg = cfg
        self.chips = chips
        self.db = dtype_bytes
        self.n_params = cfg.param_count()
        self.n_active = cfg.active_param_count()
        self.kv_per_tok = kv_bytes_per_token(cfg, dtype_bytes)
        self.state_per_seq = state_bytes_per_seq(cfg)
        # calibration: multiplicative factors from measured artifacts
        self.flops_scale = 1.0
        self.bytes_scale = 1.0
        if calibration:
            self.flops_scale = calibration.get("flops_scale", 1.0)
            self.bytes_scale = calibration.get("bytes_scale", 1.0)

    @classmethod
    def from_calibration_file(cls, cfg, path, **kw):
        calib = None
        if os.path.exists(path):
            with open(path) as f:
                calib = json.load(f).get(cfg.name)
        return cls(cfg, calibration=calib, **kw)

    # ------------------------------------------------------------------
    def _attn_flops(self, n_new: int, kv_len: int, batch: int) -> float:
        """Attention score+value FLOPs (grows with context)."""
        cfg = self.cfg
        total = 0.0
        for kind in cfg.layer_kinds():
            if kind == "attn":
                eff_kv = kv_len
            elif kind == "local_attn":
                eff_kv = min(kv_len, cfg.sliding_window or kv_len)
            else:
                continue
            total += 4.0 * batch * n_new * eff_kv * cfg.n_heads * cfg.head_dim
        return total

    def _cost(self, flops: float, bytes_: float) -> StepCost:
        c = flops / (self.chips * PEAK_FLOPS * MATMUL_EFF)
        m = bytes_ / (self.chips * HBM_BW * BW_EFF)
        return StepCost(max(c, m), c, m, flops, bytes_)

    def prefill(self, n_new: int, kv_len: int, batch: int = 1) -> StepCost:
        """Process ``n_new`` prompt tokens against ``kv_len`` existing cache."""
        flops = (2.0 * self.n_active * n_new * batch
                 + self._attn_flops(n_new, kv_len + n_new, batch))
        flops *= self.flops_scale
        bytes_ = (self.n_params * self.db          # weights stream once
                  + batch * (kv_len + n_new) * self.kv_per_tok) * self.bytes_scale
        return self._cost(flops, bytes_)

    def decode_step(self, batch: int, avg_kv_len: float) -> StepCost:
        """One token for every sequence in the decode batch."""
        flops = (2.0 * self.n_active * batch
                 + self._attn_flops(1, int(avg_kv_len), batch)) * self.flops_scale
        bytes_ = (self.n_params * self.db
                  + batch * (avg_kv_len * self.kv_per_tok + self.state_per_seq)
                  ) * self.bytes_scale
        return self._cost(flops, bytes_)


class SwapCostModel:
    """Swap-vs-recompute pricing for preemption (``serving/preempt.py``).

    Swapping a victim costs two host transfers (out now, back at resume)
    at MEASURED device<->host bandwidth: every transfer the
    ``HostSwapPool`` makes feeds ``observe``, so the estimate converges on
    the link the engine really has. Recomputing costs one prefill of the
    tokens the radix cache cannot serve.
    """

    #: host-link prior before any measurement (bytes/s): unmeasured, the
    #: reference's conservative figure; the first observed transfer replaces it
    DEFAULT_HOST_BW = 10e9

    def __init__(self, cost: CostModel):
        self.cost = cost
        self.host_bw = self.DEFAULT_HOST_BW
        self.samples = 0

    def observe(self, nbytes: int, seconds: float) -> None:
        """EWMA a measured host transfer into the bandwidth estimate."""
        if seconds <= 0 or nbytes <= 0:
            return
        bw = nbytes / seconds
        self.host_bw = bw if self.samples == 0 else (
            0.8 * self.host_bw + 0.2 * bw)
        self.samples += 1

    def transfer_s(self, nbytes: int) -> float:
        return nbytes / max(self.host_bw, 1.0)

    def recompute_s(self, cold_tokens: int, kv_len: int) -> float:
        """Re-prefill cost for the tokens the prefix/relay cache misses."""
        if cold_tokens <= 0:
            return 0.0
        return self.cost.prefill(cold_tokens, kv_len - cold_tokens).seconds

    def choose(self, *, swap_bytes: int, cold_tokens: int,
               kv_len: int) -> str:
        """'recompute' when re-prefilling the cache-cold tail beats moving
        the KV host-side and back; 'swap' otherwise."""
        round_trip = self.transfer_s(2 * swap_bytes)
        return ("recompute"
                if self.recompute_s(cold_tokens, kv_len) < round_trip
                else "swap")
