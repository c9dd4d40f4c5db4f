"""Model configuration system (copy of ``repro.configs.base``).

Every assigned architecture (plus the paper's own backbones) is expressed as a
``ModelConfig``. The same dataclass drives model construction, sharding policy,
dry-run input specs, and the serving cost model.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Layer kinds usable in ``layer_pattern`` (the repeating block group).
ATTN = "attn"            # global full attention
LOCAL_ATTN = "local_attn"  # sliding-window attention
RGLRU = "rglru"          # RG-LRU recurrent block (Griffin / RecurrentGemma)
SSD = "ssd"              # Mamba-2 state-space duality block


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int                   # decoder layers (pattern repeats to this depth)
    d_model: int
    n_heads: int                    # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // n_heads

    # --- attention features ---
    rope_style: str = "full"        # full | partial (chatglm 2d/partial rotary) | none
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None    # gemma2 attention logit softcap
    final_softcap: Optional[float] = None   # gemma2 final logit softcap
    sliding_window: int = 0                 # window for local_attn layers
    layer_pattern: Tuple[str, ...] = (ATTN,)
    qk_norm: bool = False                   # qwen3-style per-head q/k RMSNorm

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0

    # --- SSM / recurrent ---
    ssm_state: int = 0              # mamba2 N (state size per head)
    ssm_head_dim: int = 64          # mamba2 P
    ssm_expand: int = 2             # d_inner = expand * d_model
    conv_width: int = 4
    rglru_width: int = 0            # RG-LRU recurrent width (0 -> d_model)

    # --- encoder-decoder ---
    encoder_layers: int = 0         # > 0 => enc-dec (decoder cross-attends)

    # --- modality frontend (stubbed per spec) ---
    input_mode: str = "tokens"      # tokens | embeds (audio frames / vision patches)
    n_prefix_embeds: int = 0        # VLM: patch embeds prepended to token embeds

    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""                # citation for the config

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ------------------------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def uses_attention(self) -> bool:
        return any(k in (ATTN, LOCAL_ATTN) for k in self.layer_pattern)

    @property
    def subquadratic(self) -> bool:
        """True if no layer holds unbounded full-attention KV... except that we
        treat gemma2-style half-sliding-window as eligible for long-context
        decode (decode is O(L) per token; see DESIGN.md §4)."""
        return ATTN not in self.layer_pattern

    @property
    def long_context_ok(self) -> bool:
        """Eligible for the long_500k decode shape."""
        if self.subquadratic:
            return True
        # dense archs qualify only with a native sliding-window variant
        return LOCAL_ATTN in self.layer_pattern and self.sliding_window > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Expanded per-layer kinds of the full decoder stack."""
        pat = self.layer_pattern
        reps = -(-self.n_layers // len(pat))
        return (pat * reps)[: self.n_layers]

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND roofline."""
        d, f, V = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        per_kind = {}
        per_kind[ATTN] = per_kind[LOCAL_ATTN] = (
            d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        )
        mlp = 3 * d * f  # gated MLP
        if self.is_moe:
            moe = self.n_experts * 3 * d * f + d * self.n_experts
            mlp = moe + self.n_shared_experts * 3 * d * f
        d_in = self.ssm_expand * d
        if self.ssm_state:
            nh = d_in // self.ssm_head_dim
            per_kind[SSD] = (
                d * (2 * d_in + 2 * self.ssm_state + nh)  # in_proj for x,z,B,C,dt
                + self.conv_width * (d_in + 2 * self.ssm_state)
                + d_in * d
                + 2 * nh
            )
        w = self.rglru_width or d
        per_kind[RGLRU] = d * w * 2 + 3 * w * w // 1 + w * d if RGLRU in self.layer_pattern else 0
        # NOTE: rglru block = in proj (d->w x2 gates), conv, rg-lru gates (w->w x2), out proj
        attn_like = 0
        for kind in self.layer_kinds():
            blk = per_kind.get(kind, 0)
            if kind in (ATTN, LOCAL_ATTN):
                blk += mlp
            elif kind == RGLRU:
                blk += mlp if self.d_ff else 0
            attn_like += blk + 2 * d  # norms
        total += attn_like
        if self.is_encdec:
            # encoder: self-attn + mlp; decoder blocks above get cross-attn added
            enc_block = per_kind[ATTN] + 3 * d * f + 2 * d
            total += self.encoder_layers * enc_block
            total += self.n_layers * (per_kind[ATTN] + d)  # cross-attn
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k experts only)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = (self.top_k + self.n_shared_experts) * 3 * d * f
        n_moe_layers = sum(1 for k in self.layer_kinds() if k in (ATTN, LOCAL_ATTN))
        return self.param_count() - n_moe_layers * (dense_moe - active_moe)

    # ------------------------------------------------------------------
    def reduced(self, n_layers: int = 2, d_model: int = 256, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (<=4 experts etc.)."""
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = max(1, min(self.n_kv_heads, n_heads)) if n_heads else 0
        d_model = min(d_model, 512)
        updates = dict(
            name=self.name + "-smoke",
            n_layers=max(n_layers, len(self.layer_pattern)),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=(d_model // n_heads) if n_heads else 0,
            d_ff=d_model * 2 if self.d_ff else 0,
            vocab_size=vocab,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            capacity_factor=8.0 if self.n_experts else self.capacity_factor,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            rglru_width=d_model if self.rglru_width else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            n_prefix_embeds=min(self.n_prefix_embeds, 8),
            dtype="float32",
        )
        return dataclasses.replace(self, **updates)


# ----------------------------------------------------------------------
# Input shapes (assigned)
@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = InputShape("train_4k", 4096, 256, "train")
PREFILL_32K = InputShape("prefill_32k", 32768, 32, "prefill")
DECODE_32K = InputShape("decode_32k", 32768, 128, "decode")
LONG_500K = InputShape("long_500k", 524288, 1, "decode")

INPUT_SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


# ----------------------------------------------------------------------
_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


ASSIGNED = [
    "granite-moe-3b-a800m", "gemma2-27b", "seamless-m4t-medium", "chatglm3-6b",
    "recurrentgemma-2b", "granite-8b", "internlm2-1.8b", "grok-1-314b",
    "internvl2-76b", "mamba2-780m",
]


def _load_all():
    # the port registers only the configs its slices serve so far
    import importlib
    for m in ("llama31_8b",):
        importlib.import_module(f"repro_torch.configs.{m}")
