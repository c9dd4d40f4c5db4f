"""gemma2-27b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118]
"""
from repro_torch.configs.base import ModelConfig, register, LOCAL_ATTN, ATTN

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    layer_pattern=(LOCAL_ATTN, ATTN),
    sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    rope_theta=10000.0,
    source="arXiv:2408.00118",
))
