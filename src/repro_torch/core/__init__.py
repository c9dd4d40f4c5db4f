from repro_torch.core.prefillshare import (CacheSchema, base_prefill,
                                           base_prefill_paged, cache_schema,
                                           model_fingerprint)
