from repro_torch.training.optim import AdamW, apply_updates, constant_lr, warmup_cosine
