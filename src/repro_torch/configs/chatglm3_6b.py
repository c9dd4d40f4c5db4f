"""chatglm3-6b [dense] — partial (2d) RoPE, extreme GQA (kv=2).

[arXiv:2406.12793]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    arch_type="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=65024,
    rope_style="partial",          # rotary on half the head dims (GLM 2d RoPE)
    source="arXiv:2406.12793",
))
