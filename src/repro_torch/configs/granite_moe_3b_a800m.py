"""granite-moe-3b-a800m [moe] — IBM Granite 3.0 3B-A800M MoE.

[hf:ibm-granite/granite-3.0-3b-a800m-base] (assignment bracket cites the
1b-a400m card with 32 experts; the assigned numbers — 32L/1536/24H/40e top-8 —
match the 3b-a800m card, which we follow; see DESIGN.md deviations).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512,                      # per-expert FFN width
    vocab_size=49155,
    n_experts=40, top_k=8,
    rope_theta=10000.0,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base (assigned); 3b-a800m dims",
))
