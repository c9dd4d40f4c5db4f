"""Qwen3-1.7B/8B/14B-Base — the paper's scale-sweep backbones.

[arXiv:2505.09388]
"""
from repro_torch.configs.base import ModelConfig, register

QWEN3_1_7B = register(ModelConfig(
    name="qwen3-1.7b",
    arch_type="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=6144, vocab_size=151936, qk_norm=True, rope_theta=1000000.0,
    source="arXiv:2505.09388",
))

QWEN3_8B = register(ModelConfig(
    name="qwen3-8b",
    arch_type="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=12288, vocab_size=151936, qk_norm=True, rope_theta=1000000.0,
    source="arXiv:2505.09388 (paper's backbone)",
))

QWEN3_14B = register(ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, qk_norm=True, rope_theta=1000000.0,
    source="arXiv:2505.09388 (paper Appendix B.3 backbone)",
))
