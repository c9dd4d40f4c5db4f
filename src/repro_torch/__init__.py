"""PrefillShare on PyTorch + hand-written Hopper kernels.

A port of the ``repro`` package (JAX/Pallas on TPU), module for module.
It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit CPU request it raises.
"""
