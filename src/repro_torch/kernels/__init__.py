"""Hopper kernels of the port, each beside its plain PyTorch version.

``paged_decode`` and ``paged_write`` replace the Pallas TPU kernels of the
same names in ``repro.kernels``; ``ref`` holds their plain versions and
``_build`` compiles ``csrc/*.cu`` at first use."""
