"""granite-8b [dense] — llama-architecture code model.

[arXiv:2405.04324]
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-8b",
    arch_type="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=49152,
    source="arXiv:2405.04324",
))
