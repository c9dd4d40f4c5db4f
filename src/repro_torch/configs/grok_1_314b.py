"""grok-1-314b [moe] — 8 experts top-2.

[hf:xai-org/grok-1]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    arch_type="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    n_experts=8, top_k=2,
    attn_softcap=30.0,             # grok uses attention logit softcapping
    source="hf:xai-org/grok-1",
))
