"""recurrentgemma-2b [hybrid] — Griffin: RG-LRU + local attention, 1 attn : 2 recurrent.

[arXiv:2402.19427]
"""
from repro_torch.configs.base import ModelConfig, register, RGLRU, LOCAL_ATTN

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b",
    arch_type="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    layer_pattern=(RGLRU, RGLRU, LOCAL_ATTN),
    sliding_window=2048,
    rglru_width=2560,
    source="arXiv:2402.19427",
))
