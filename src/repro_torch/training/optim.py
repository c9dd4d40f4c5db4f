"""AdamW (the paper's Appendix A settings) and learning-rate schedules.

Port of ``repro.training.optim`` with its roundings: moments computed in
fp32 and stored in ``moment_dtype``; decoupled weight decay on matrices
(``ndim >= 2``) only; each update cast to its parameter's dtype, then added
in that dtype; the global clip norm summed in fp32 over the leaves in
``tree_leaves`` order. The state is explicit (``AdamWState``, on the
parameters' device); the optimizer object holds none.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.params import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor        # () int32, on the parameters' device
    m: Any
    v: Any


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(base_lr: float, total_steps: int, warmup_ratio: float = 0.03,
                  final_frac: float = 0.1) -> Callable:
    """Linear warmup over ``warmup_ratio`` of the steps, then a cosine decay
    to ``final_frac * base_lr``."""
    warm = max(1, int(total_steps * warmup_ratio))

    def lr(step):
        step = _f32(step)
        w = base_lr * step / warm
        t = torch.clamp((step - warm) / max(total_steps - warm, 1), 0.0, 1.0)
        c = base_lr * (final_frac + (1 - final_frac) * 0.5
                       * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warm, w, c)

    return lr


def constant_lr(base_lr: float) -> Callable:
    return lambda step: torch.full_like(_f32(step), base_lr)


class AdamW:
    """AdamW (Loshchilov & Hutter 2017). β1=0.9, β2=0.999, wd=0.1 per the
    paper; ``moment_dtype`` (e.g. ``torch.bfloat16``) halves the moments'
    memory; ``grad_clip`` > 0 clips the global gradient norm."""

    def __init__(self, lr_fn, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.1,
                 moment_dtype=torch.float32, grad_clip: float = 0.0):
        self.lr_fn = lr_fn if callable(lr_fn) else constant_lr(lr_fn)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.moment_dtype = moment_dtype
        self.grad_clip = grad_clip

    def init(self, params) -> AdamWState:
        def z(p):
            return torch.zeros_like(p, dtype=self.moment_dtype)
        device = tree_leaves(params)[0].device
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=device),
                          m=tree_map(z, params), v=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params):
        """Returns (updates, new state); ``apply_updates`` adds them."""
        step = state.step + 1
        if self.grad_clip:
            gn = torch.sqrt(sum(g.float().square().sum()
                                for g in tree_leaves(grads)))
            scale = torch.clamp(torch.full_like(gn, self.grad_clip)
                                / torch.clamp(gn, min=1e-9), max=1.0)
            grads = tree_map(lambda g: g.float() * scale, grads)
        b1, b2, md = self.b1, self.b2, self.moment_dtype
        m = tree_map(lambda mm, g: (b1 * mm.float() + (1 - b1) * g.float()
                                    ).to(md), state.m, grads)
        v = tree_map(lambda vv, g: (b2 * vv.float()
                                    + (1 - b2) * g.float().square()).to(md),
                     state.v, grads)
        sf = step.float()
        bc1 = 1 - b1 ** sf
        bc2 = 1 - b2 ** sf
        lr = self.lr_fn(step)

        def upd(p, mm, vv):
            u = (mm.float() / bc1) / (torch.sqrt(vv.float() / bc2) + self.eps)
            if p.dim() >= 2:          # decoupled weight decay on matrices only
                u = u + self.wd * p.float()
            return (-lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), AdamWState(step=step, m=m, v=v)


@torch.no_grad()
def apply_updates(params, updates):
    return tree_map(lambda p, u: p + u, params, updates)
