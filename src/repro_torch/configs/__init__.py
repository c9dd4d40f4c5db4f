from repro_torch.configs.base import (
    ModelConfig, InputShape, INPUT_SHAPES, TRAIN_4K, PREFILL_32K, DECODE_32K,
    LONG_500K, ASSIGNED, get_config, list_configs, register,
    ATTN, LOCAL_ATTN, RGLRU, SSD,
)
