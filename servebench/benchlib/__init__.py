"""The benchmark harness of the PyTorch port (``src/repro_torch``).

``servebench/run.py`` is the command; this package holds what every cell
shares: reading the data files (``spec``), the seeded weights
(``weights``), the one traffic generator (``traffic``), the closed loop
of clients and its window (``loop``), the profiler's reduction
(``devtrace``), the work arithmetic (``cost``), exact percentiles
(``stats``, ``tails``) and the correctness check (``check``). Nothing here
imports JAX or the JAX package; the plain reference lives in
``servebench/reference`` and imports nothing of the port.
"""
