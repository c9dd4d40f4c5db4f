"""mamba2-780m [ssm] — attention-free SSD (state-space duality).

[arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig, register, SSD

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48, d_model=1536, n_heads=0, n_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    layer_pattern=(SSD,),
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, conv_width=4,
    rope_style="none",
    source="arXiv:2405.21060",
))
