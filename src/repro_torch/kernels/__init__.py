"""Hopper kernels of the port, each beside its plain PyTorch version.

Each replaces the Pallas TPU kernel of the same name in ``repro.kernels``:
  flash_prefill       -- dense flash attention for the prefill stage
  flash_prefill_paged -- chunk-prefill attention straight over the pool
  paged_decode        -- decode attention over the shared paged KV pool
  paged_write         -- prefill -> pool page scatter (the handoff data plane)
``ops`` holds the public wrappers in the model's layout, ``ref`` the plain
versions, and ``_build`` compiles ``csrc/*.cu`` at a kernel's first launch
(importing this package builds nothing).
"""
from repro_torch.kernels.ops import (flash_attention, paged_attention,
                                     paged_prefill)
from repro_torch.kernels.paged_write import paged_write

__all__ = ["flash_attention", "paged_attention", "paged_prefill",
           "paged_write"]
