"""internvl2-76b [vlm] — InternViT + LLaMA3-70B-class language backbone.

[arXiv:2404.16821]. The InternViT-6B vision encoder + MLP projector are STUBBED
per the assignment carve-out: ``input_specs`` supplies precomputed patch
embeddings prepended to token embeddings; we implement the 80-layer language
decoder that consumes them.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b",
    arch_type="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=28672, vocab_size=128256,
    input_mode="mixed", n_prefix_embeds=256,   # 256 visual patch tokens
    rope_theta=500000.0,
    source="arXiv:2404.16821",
))
