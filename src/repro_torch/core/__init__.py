from repro_torch.core.prefillshare import (CacheSchema, base_prefill,
                                           base_prefill_paged,
                                           cache_conditioned_loss,
                                           cache_schema, full_ft_loss,
                                           mix_caches, model_fingerprint)
