"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone.

[arXiv:2308.11596]. The speech frontend (mel + conformer feature extractor) is
STUBBED per the assignment carve-out: ``input_specs`` supplies precomputed frame
embeddings consumed by the text/unit encoder; we implement the enc-dec
transformer backbone (12 encoder + 12 decoder layers).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-medium",
    arch_type="audio",
    n_layers=12, encoder_layers=12,
    d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=256206,
    input_mode="embeds",
    source="arXiv:2308.11596",
))
