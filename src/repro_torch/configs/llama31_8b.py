"""LLaMA-3.1-8B — the paper's own serving/training backbone.

[arXiv:2407.21783]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama31-8b",
    arch_type="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=128256,
    rope_theta=500000.0, tie_embeddings=False,
    source="arXiv:2407.21783 (paper's backbone)",
))
