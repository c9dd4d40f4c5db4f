"""Seeded weights, drawn on the device in the port's parameter layout.

The layout (tree keys, shapes, dtypes) is the port's
``repro_torch.models.param_shapes``; the numbers come from a generator of
the harness's own, one ``normal_`` per leaf, in the leaf's serving dtype
(bf16), so no full-size fp32 temporary is made. The base model is one
tree; the decoders are ONE tree with a leading model axis whose rows the
engine serves as views (the fused plane stacks them without a copy).

Init: normal with std 1/sqrt(fan_in) (fan_in the leaf's second-last
dim), 0.02 for the embeddings, zeros for the norms
(RMSNorm stores scale - 1). Tied-embedding configurations with random
weights answer with their last input token unless the output projections
outweigh the embedding (``repro_torch/launch/main_path.py``, ``OUT_SCALE``),
so every leaf named ``wo`` is scaled by the configuration's
``output_scale``.
"""
from __future__ import annotations

import numpy as np
import torch


def _seeds(seed: int, n: int) -> list:
    """``n`` 63-bit generator seeds from the run's seed (any whole number)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 63), 0x5EED])
    return [int(x) for x in ss.generate_state(n, dtype=np.uint64) >> 1]


def _fill(shapes, lead: tuple, gen, device, out_scale: float, path=()):
    if isinstance(shapes, dict):
        return {k: _fill(v, lead, gen, device, out_scale, path + (k,))
                for k, v in shapes.items()}
    if isinstance(shapes, list):
        return [_fill(v, lead, gen, device, out_scale, path + (i,))
                for i, v in enumerate(shapes)]
    name = path[-1]
    t = torch.empty(lead + tuple(shapes.shape), dtype=shapes.dtype,
                    device=device)
    if name.startswith("norm") or name == "final_norm":
        return t.zero_()
    if name in ("embed", "unembed"):
        std = 0.02
    else:
        std = float(shapes.shape[-2]) ** -0.5
        if name == "wo":
            std *= out_scale
    return t.normal_(0.0, std, generator=gen)


def build(cfg, seed: int, n_decoders: int, device, out_scale: float):
    """``(base, decoders)``: the base tree and the decoders' stacked tree
    (leading axis ``n_decoders``), on ``device``; the engine serves the
    decoders as views of its rows (``core.lora.unstack_params``)."""
    from repro_torch.models.model import param_shapes
    shapes = param_shapes(cfg)
    device = torch.device(device)
    s_base, s_dec = _seeds(seed, 2)
    g = torch.Generator(device=device)
    g.manual_seed(s_base)
    base = _fill(shapes, (), g, device, out_scale)
    g.manual_seed(s_dec)
    stacked = _fill(shapes, (n_decoders,), g, device, out_scale)
    return base, stacked

