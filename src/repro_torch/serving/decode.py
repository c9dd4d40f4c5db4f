"""Fused cross-model decode plane: stacked decoders, ONE forward per step.

Port of ``repro.serving.decode`` for full-weight groups. Every decode module
sharing a ``ModelConfig`` is structurally identical, so their weights stack
on a leading model axis (``core.lora.stack_params``) and one forward
advances EVERY active sequence of EVERY model per engine step.

The reference vmaps M model lanes over lane-local copies of the pool, which
XLA fuses away; in eager torch those would be M real copies of the pool.
The port does not copy it. Per step (``StackedDecoders.step``):
  - sequences are bucketed per model into an (M, Bmax) grid; padding rows
    carry block tables of sentinel page 0 (never allocated);
  - block-table width is bucketed to the next power of two, so the shapes a
    step sees grow O(log) with context;
  - projections and the MLP are batched matrix products over the model
    axis, and attention is ONE ``paged_decode`` launch per layer over the
    flattened M * Bmax batch (``models.model.decode_stacked``);
  - every row writes its K/V straight into the shared pool. That is exact:
    written pages are private per sequence, and padding rows write only to
    sentinel page 0, which is never read as live KV.
Greedy: the next token is the argmax of the fp32 logits (exactly the
reference's ``temperature=0`` path).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.lora import model_axis_order, stack_params
from repro_torch.models import decode_stacked


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the block-table width bucket."""
    return 1 << max(0, int(n) - 1).bit_length()


def group_specs(specs):
    """Partition ``{model_id: (cfg, DecodeModelSpec)}`` into fusable groups:
    models sharing an identical ModelConfig and weight layout stack into one
    StackedDecoders; each distinct group costs one dispatch per step."""
    groups: dict = {}
    for mid, (cfg, spec) in specs.items():
        groups.setdefault((cfg, spec.group_key()), {})[mid] = spec
    return groups


class StackedDecoders:
    """All decode modules of ONE fusable group, stacked for the fused step."""

    def __init__(self, cfg, members: dict, kvpool):
        if not members:
            raise ValueError("need at least one decode module")
        self.cfg = cfg
        self.kvpool = kvpool
        self.page_size = kvpool.page_size
        mids = sorted(members)
        self.model_ids = [mids[i] for i in model_axis_order(     # stable
            [members[mid].full for mid in mids])]
        self.index = {mid: m for m, mid in enumerate(self.model_ids)}
        self.stacked = stack_params([members[mid].full
                                     for mid in self.model_ids])
        self.dispatches = 0                          # fused-step invocations

    @torch.no_grad()
    def step(self, seqs) -> list:
        """Advance every sequence (any mix of this group's models) one token
        in ONE forward; returns the greedy next tokens aligned with
        ``seqs``. Tail pages must already cover position ``pos``."""
        M = len(self.model_ids)
        counts = [0] * M
        coords = []
        for s in seqs:
            m = self.index[s.model_id]
            coords.append((m, counts[m]))
            counts[m] += 1
        bmax = max(counts)
        npages = next_pow2(max(len(s.block_table) for s in seqs))
        toks = np.zeros((M, bmax), np.int32)
        pos = np.zeros((M, bmax), np.int32)
        bts = np.zeros((M * bmax, npages), np.int32)  # pad = sentinel page 0
        for s, (m, b) in zip(seqs, coords):
            toks[m, b] = s.next_token
            pos[m, b] = s.pos
            bts[m * bmax + b, :len(s.block_table)] = s.block_table
        dev = self.kvpool.device
        k_layers, v_layers = self.kvpool.layers()
        logits = decode_stacked(self.cfg, self.stacked,
                                torch.from_numpy(toks).to(dev),
                                torch.from_numpy(pos).to(dev),
                                k_layers, v_layers,
                                torch.from_numpy(bts).to(dev))
        nxt = logits.argmax(-1).to(torch.int32).cpu()        # (M, Bmax)
        self.dispatches += 1
        seq_m = torch.tensor([m for m, _ in coords])
        seq_b = torch.tensor([b for _, b in coords])
        return nxt[seq_m, seq_b].tolist()


class FusedDecodePlane:
    """Routes sequences to their group's StackedDecoders: one dispatch per
    engine step per distinct (ModelConfig, weight-layout) group, ONE total
    when every decode module shares the engine's config (the paper's
    setting). The plane is an immutable snapshot of the registry's model
    set: churn REPLACES it at a step boundary, carrying the dispatch counter
    forward."""

    def __init__(self, specs, kvpool, *, dispatches0: int = 0):
        """specs: {model_id: (cfg, DecodeModelSpec)}."""
        self.groups = [StackedDecoders(cfg, members, kvpool)
                       for (cfg, _k), members in group_specs(specs).items()]
        self._group_of = {mid: g for g in self.groups for mid in g.model_ids}
        self._dispatches0 = dispatches0

    @property
    def model_ids(self) -> list:
        return sorted(self._group_of)

    @property
    def dispatches(self) -> int:
        return self._dispatches0 + sum(g.dispatches for g in self.groups)

    def step(self, seqs) -> list:
        """One engine decode step; returns next tokens aligned with seqs."""
        nxt = [0] * len(seqs)
        for g in self.groups:
            idx = [i for i, s in enumerate(seqs)
                   if self._group_of[s.model_id] is g]
            if idx:
                for i, t in zip(idx, g.step([seqs[i] for i in idx])):
                    nxt[i] = t
        return nxt
