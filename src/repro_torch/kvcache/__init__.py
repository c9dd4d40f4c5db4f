from repro_torch.kvcache.blocks import BlockPool, PoolExhausted
from repro_torch.kvcache.handoff import (HandoffChannel, HandoffPlan,
                                         SchemaMismatch)
from repro_torch.kvcache.manager import (Allocation, CacheManager, CacheStats,
                                         kv_bytes_per_token,
                                         state_bytes_per_seq)
from repro_torch.kvcache.paged import PagedKVPool
from repro_torch.kvcache.radix import NullPrefixIndex, PrefixIndex
from repro_torch.kvcache.sanitize import (PoolSanitizer, SanitizerError,
                                          check_index, check_pool)
