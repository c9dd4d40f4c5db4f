"""Training loops: base pretraining, full fine-tuning and cache-conditioned
fine-tuning, plus greedy evaluation with shared / self / mixed caches (the
Fig. 2 machinery).

Port of ``repro.training.trainer``. A step is a plain loop: the loss with
autograd recording (the model's functional cache path), ``backward``, AdamW
and the update. Gradients reach only the tree being trained: the step
differentiates fresh leaves of that tree, and every other tree (the frozen
base) enters the loss with ``requires_grad=False`` and, for its prefill
cache, detached. Trees come back detached, and no input tensor is written.
"""
from __future__ import annotations

import functools
from typing import Callable, Iterable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefillshare import (base_prefill,
                                           cache_conditioned_loss,
                                           full_ft_loss, mix_caches)
from repro_torch.models import forward
from repro_torch.params import tree_leaves, tree_map
from repro_torch.training import data as D
from repro_torch.training.optim import AdamW, apply_updates


class Trainer:
    """A generic (loss, AdamW) loop over keyword batches."""

    def __init__(self, loss_fn: Callable, opt: AdamW):
        self.loss_fn, self.opt = loss_fn, opt

    def step(self, params, opt_state, batch: dict):
        """One step on a batch of tensors: (new params, new state, loss)."""
        p = tree_map(lambda x: x.detach().requires_grad_(True), params)
        out = self.loss_fn(p, **batch)
        loss = out[0] if isinstance(out, tuple) else out
        loss.backward()
        # a leaf the loss does not reach has zero gradient, as under jax.grad
        grads = tree_map(lambda x: torch.zeros_like(x) if x.grad is None
                         else x.grad, p)
        p = tree_map(torch.Tensor.detach, p)
        updates, opt_state = self.opt.update(grads, opt_state, p)
        return apply_updates(p, updates), opt_state, loss.detach()

    def fit(self, params, batches: Iterable[dict], log_every: int = 0,
            tag: str = ""):
        """Train over ``batches`` (dicts of numpy arrays, moved to the
        params' device); returns (params, per-step losses)."""
        device = tree_leaves(params)[0].device
        opt_state = self.opt.init(params)
        losses = []
        for i, batch in enumerate(batches):
            batch = {k: torch.as_tensor(v).to(device)
                     for k, v in batch.items()}
            params, opt_state, loss = self.step(params, opt_state, batch)
            losses.append(float(loss))
            if log_every and (i + 1) % log_every == 0:
                print(f"[{tag}] step {i+1}: loss "
                      f"{np.mean(losses[-log_every:]):.4f}")
        return params, losses


# ----------------------------------------------------------------------
# Convenience wiring for the synthetic domains


def _task_feed(spec, seed: int, steps: int, batch: int):
    return ({"prompt": b.prompt, "target_in": b.target_in,
             "target_out": b.target_out, "target_mask": b.target_mask}
            for b in D.batches(seed, spec, batch, steps))


def pretrain_batches(cfg: ModelConfig, seed: int, steps: int, batch: int,
                     spec: D.TaskSpec | None = None):
    """Plain LM batches over the task mixture (the 'foundation' corpus)."""
    spec = spec or D.TaskSpec(domain="mix", vocab=cfg.vocab_size)
    for b in D.batches(seed, spec, batch, steps):
        tokens = np.concatenate([b.prompt, b.target_in], 1)
        tgt = np.concatenate([b.prompt[:, 1:], b.target_in[:, :1],
                              b.target_out], 1)
        mask = np.concatenate([(b.prompt != D.PAD).astype(np.float32)[:, 1:],
                               np.ones((b.prompt.shape[0], 1), np.float32),
                               b.target_mask], 1)
        yield {"tokens": tokens, "targets": tgt, "mask": mask}


def finetune_full(cfg: ModelConfig, params, domain: str, *, seed: int,
                  steps: int, batch: int, lr: float = 1e-3,
                  log_every: int = 0, spec: D.TaskSpec | None = None):
    spec = spec or D.TaskSpec(domain=domain, vocab=cfg.vocab_size)
    tr = Trainer(functools.partial(full_ft_loss, cfg),
                 AdamW(lr, weight_decay=0.01))
    return tr.fit(params, _task_feed(spec, seed, steps, batch),
                  log_every=log_every, tag=f"full-ft/{domain}")


def finetune_cache_conditioned(cfg: ModelConfig, dec_params, base_params,
                               domain: str, *, seed: int, steps: int,
                               batch: int, lr: float = 1e-3,
                               share_ratio: float = 1.0, log_every: int = 0,
                               spec: D.TaskSpec | None = None):
    """Eq. 7 fine-tuning of ``dec_params`` against the frozen
    ``base_params`` (which may be the same tree: the step trains fresh
    leaves, the base's tensors are never written)."""
    spec = spec or D.TaskSpec(domain=domain, vocab=cfg.vocab_size)

    def loss_fn(p, **kw):
        return cache_conditioned_loss(cfg, p, base_params,
                                      share_ratio=share_ratio, **kw)

    tr = Trainer(loss_fn, AdamW(lr, weight_decay=0.01))
    return tr.fit(dec_params, _task_feed(spec, seed, steps, batch),
                  log_every=log_every, tag=f"cachecond/{domain}")


# ----------------------------------------------------------------------
# Evaluation: greedy decode conditioned on a (possibly foreign) prompt cache


@torch.no_grad()
def _greedy(cfg: ModelConfig, dec_params, cache, pos, first_token,
            n_steps: int):
    """``n_steps`` greedy tokens (B, n_steps) from ``cache`` (written in
    place: the serving path)."""
    tok, toks = first_token, []
    for _ in range(n_steps):
        logits, cache, _ = forward(cfg, dec_params, tok[:, None], cache=cache,
                                   pos=pos)
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok)
        pos = pos + 1
    return torch.stack(toks, dim=1)


@torch.no_grad()
def evaluate(cfg: ModelConfig, dec_params, base_params, domain: str, *,
             seed: int, batches: int = 4, batch: int = 64,
             share_ratio: float = 1.0, spec: D.TaskSpec | None = None,
             per_token: bool = False) -> float:
    """Exact-match accuracy decoding from a prompt cache that is
    share_ratio-mixed between the base model's (shared) and the decode
    model's own prefill. ratio=1 -> PrefillShare serving; ratio=0 ->
    classic per-model serving. ``per_token``: the share of correct answer
    tokens instead."""
    spec = spec or D.TaskSpec(domain=domain, vocab=cfg.vocab_size)
    device = tree_leaves(dec_params)[0].device
    accs = []
    for b in D.batches(seed + 1000, spec, batch, batches):
        Bn, Sp = b.prompt.shape
        St = b.target_out.shape[1]
        cache_len = Sp + St + 1
        prompt = torch.as_tensor(b.prompt).to(device)
        _, c_base = base_prefill(cfg, base_params, prompt, cache_len=cache_len)
        if share_ratio < 1.0:
            _, c_self = base_prefill(cfg, dec_params, prompt,
                                     cache_len=cache_len)
            cache = mix_caches(cfg, c_base, c_self, share_ratio)
        else:
            cache = c_base
        pos = torch.full((Bn,), Sp, dtype=torch.int32, device=device)
        first = torch.full((Bn,), D.SEP, dtype=torch.int32, device=device)
        pred = _greedy(cfg, dec_params, cache, pos, first, St).cpu().numpy()
        if per_token:
            ok = ((pred == b.target_out) * b.target_mask).sum()
            accs.append(ok / b.target_mask.sum())
        else:
            accs.append(D.answer_accuracy(pred, b.target_out, b.target_mask))
    return float(np.mean(accs))
