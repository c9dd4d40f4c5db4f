"""Fused cross-model decode plane: stacked decoders, ONE forward per step.

Port of ``repro.serving.decode``. Every decode module sharing a
``ModelConfig`` is structurally identical, so one forward advances EVERY
active sequence of EVERY model of a group per engine step.

Weight layout per group (``DecodeModelSpec.group_key``):
  - FULL specs stack complete param trees on a leading model axis
    (``core.lora.stack_params``);
  - LORA specs stack ONLY the A/B factors (``stack_lora_params``); the
    engine's single base copy enters the step unbatched, and each layer's
    targeted weights are merged per lane, ``W + scale * A[m] @ B[m]``, just
    before the layer runs (``core.lora.lora_lanes``): one base copy plus M
    adapter sets, never M merged models (Eq. 9 on the weight side).

The reference vmaps M model lanes over lane-local copies of the pool, which
XLA fuses away; in eager torch those would be M real copies of the pool.
The port does not copy it. Per step (``StackedDecoders.step``):
  - sequences are bucketed per model into an (M, Bmax) grid; padding rows
    carry block tables of sentinel page 0 (never allocated);
  - block-table width is bucketed to the next power of two, so the shapes a
    step sees grow O(log) with context;
  - projections and the MLP are matrix products over the model axis, and
    attention is ONE ``paged_decode`` launch per layer over the flattened
    M * Bmax batch (``models.model.decode_stacked``);
  - every real row writes its K/V straight into the shared pool. That is
    exact: written pages are private per sequence. Padding rows write
    nothing: the step passes the real rows' flat indices down, so sentinel
    page 0 stays zero, as in the reference. ``grid_rows`` keeps the last
    step's M * Bmax, padding included (the ``engine.step`` span's
    attribute).

Per-request sampling runs in the step on the real rows' fp32 logits
(``serving.sampling``): keys fold from (seed, position), so a stream does
not depend on the packing; ``temperature=0`` rows are exact argmax, and an
all-greedy batch runs the argmax alone, none of the sampler. The one host
sync per step is the read-back of the next tokens (the
``model.decode.readback`` span).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from repro_torch.core.lora import (check_layer_adapters, lora_lanes,
                                   model_axis_order, stack_lora_params,
                                   stack_params)
from repro_torch.models import decode_stacked
from repro_torch.params import tree_leaves
from repro_torch.serving.metrics import NULL_SPANS, SPAN_READBACK
from repro_torch.serving.sampling import sample_step


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the block-table width bucket."""
    return 1 << max(0, int(n) - 1).bit_length()


def sampling_arrays(seqs, device):
    """Per-sequence (temperature, top_k, top_p, seed) tensors on ``device``,
    aligned with ``seqs``, plus the host-side ``greedy_only`` flag: an
    all-greedy batch (the default) skips the sampler entirely."""
    temps = np.asarray([s.params.temperature for s in seqs], np.float32)
    top_ks = np.asarray([s.params.top_k for s in seqs], np.int32)
    top_ps = np.asarray([s.params.top_p for s in seqs], np.float32)
    seeds = np.asarray([s.params.seed for s in seqs], np.int32)
    greedy_only = bool((temps <= 0.0).all())
    return (*(torch.from_numpy(a).to(device)
              for a in (temps, top_ks, top_ps, seeds)), greedy_only)


def next_tokens(logits, seqs, device) -> list:
    """The next token of every row of ``logits`` (N, V) fp32, aligned with
    ``seqs``: argmax for an all-greedy batch (nothing of the sampler, not
    even its inputs, reaches the card), else ``sample_step`` at each
    sequence's fed position. Reads the tokens back to the host."""
    if all(s.params.temperature <= 0.0 for s in seqs):
        return logits.argmax(-1).cpu().tolist()
    *samp, _ = sampling_arrays(seqs, device)
    pos = torch.tensor([s.pos for s in seqs], dtype=torch.int32)
    return sample_step(logits, pos.to(device), *samp).cpu().tolist()


def read_back(logits, seqs, device, spans) -> list:
    """``next_tokens`` inside a ``model.decode.readback`` span of
    ``spans`` (the span takes in the argmax's, or the sampler's, launch
    before the read-back)."""
    span = spans.open(SPAN_READBACK)
    try:
        return next_tokens(logits, seqs, device)
    finally:
        spans.close(span)


def group_specs(specs):
    """Partition ``{model_id: (cfg, DecodeModelSpec)}`` into fusable groups:
    models sharing an identical ModelConfig and weight-layout bucket (all
    full, or all LoRA of one (alpha, rank)) stack into one StackedDecoders;
    each distinct group costs one dispatch per step."""
    groups: dict = {}
    for mid, (cfg, spec) in specs.items():
        groups.setdefault((cfg, spec.group_key()), {})[mid] = spec
    return groups


class StackedDecoders:
    """All decode modules of ONE fusable group, stacked for the fused step."""

    def __init__(self, cfg, members: dict, kvpool, base_params=None, *,
                 spans=NULL_SPANS):
        """``members``: {model_id: DecodeModelSpec}, all sharing ``cfg`` and
        one ``group_key``. ``base_params`` (the engine's single copy) is
        required for a LoRA group and is not copied. ``spans`` records the
        tokens' read-back (``serving.metrics``)."""
        if not members:
            raise ValueError("need at least one decode module")
        self.cfg = cfg
        self.kvpool = kvpool
        self.page_size = kvpool.page_size
        mids = sorted(members)
        self.lora = members[mids[0]].kind == "lora"
        if self.lora:
            if base_params is None:
                raise ValueError("a LoRA group needs the engine's base copy")
            self.model_ids = mids
            ad = members[mids[0]].lora
            self.alpha, self.rank = ad.alpha, ad.rank
            ab = stack_lora_params([members[m].lora.params for m in mids])
            check_layer_adapters(ab)
            self.stacked = {"base": base_params, "ab": ab}
            self._lanes = partial(lora_lanes, scale=ad.scale)
        else:
            self.model_ids = [mids[i] for i in model_axis_order(  # stable
                [members[mid].full for mid in mids])]
            self.stacked = stack_params([members[mid].full
                                         for mid in self.model_ids])
            self._lanes = None
        self.index = {mid: m for m, mid in enumerate(self.model_ids)}
        self.dispatches = 0                          # fused-step invocations
        self.grid_rows = 0                           # the last step's M*Bmax
        self.spans = spans

    def param_bytes(self) -> int:
        """Bytes of decode weights this group stores beyond the engine's
        base copy: the stacked trees of a full group, the stacked A/B
        factors only of a LoRA group (the base is shared, not copied)."""
        tree = self.stacked["ab"] if self.lora else self.stacked
        return sum(x.nbytes for x in tree_leaves(tree))

    @torch.no_grad()
    def step(self, seqs) -> list:
        """Advance every sequence (any mix of this group's models) one token
        in ONE forward; returns the next tokens aligned with ``seqs``,
        sampled per each sequence's SamplingParams (greedy at temperature
        0). Tail pages must already cover position ``pos``."""
        M = len(self.model_ids)
        counts = [0] * M
        coords = []
        for s in seqs:
            m = self.index[s.model_id]
            coords.append((m, counts[m]))
            counts[m] += 1
        bmax = max(counts)
        self.grid_rows = M * bmax
        npages = next_pow2(max(len(s.block_table) for s in seqs))
        toks = np.zeros((M, bmax), np.int32)
        pos = np.zeros((M, bmax), np.int32)
        bts = np.zeros((M * bmax, npages), np.int32)  # pad = sentinel page 0
        for s, (m, b) in zip(seqs, coords):
            toks[m, b] = s.next_token
            pos[m, b] = s.pos
            bts[m * bmax + b, :len(s.block_table)] = s.block_table
        dev = self.kvpool.device
        # the real rows' flat indices, in ``seqs`` order: they pick the
        # logits to sample, and (when the grid has padding rows) the rows
        # that write the pool
        flat = torch.tensor([m * bmax + b for m, b in coords],
                            dtype=torch.int64).to(dev)
        rows = flat if len(seqs) < M * bmax else None
        k_layers, v_layers = self.kvpool.layers()
        logits = decode_stacked(self.cfg, self.stacked,
                                torch.from_numpy(toks).to(dev),
                                torch.from_numpy(pos).to(dev),
                                k_layers, v_layers,
                                torch.from_numpy(bts).to(dev), rows=rows,
                                lanes=self._lanes)
        self.dispatches += 1
        lg = logits.reshape(M * bmax, -1).index_select(0, flat)   # (N, V)
        return read_back(lg, seqs, dev, self.spans)


class FusedDecodePlane:
    """Routes sequences to their group's StackedDecoders: one dispatch per
    engine step per distinct (ModelConfig, weight-layout) group, ONE total
    when every decode module shares the engine's config (the paper's
    setting). The plane is an immutable snapshot of the registry's model
    set: churn REPLACES it at a step boundary, carrying the dispatch counter
    forward."""

    def __init__(self, specs, kvpool, base_params=None, *,
                 dispatches0: int = 0, spans=NULL_SPANS):
        """specs: {model_id: (cfg, DecodeModelSpec)}; ``base_params``: the
        engine's single base copy, which LoRA groups read; ``spans``: where
        the groups record their read-backs."""
        self.groups = [StackedDecoders(cfg, members, kvpool, base_params,
                                       spans=spans)
                       for (cfg, _k), members in group_specs(specs).items()]
        self._group_of = {mid: g for g in self.groups for mid in g.model_ids}
        self._dispatches0 = dispatches0
        self.grid_rows = 0            # the last step's rows, padding included

    @property
    def model_ids(self) -> list:
        return sorted(self._group_of)

    @property
    def dispatches(self) -> int:
        return self._dispatches0 + sum(g.dispatches for g in self.groups)

    def param_bytes(self) -> int:
        """Decode-plane weight bytes beyond the engine's single base copy."""
        return sum(g.param_bytes() for g in self.groups)

    def step(self, seqs) -> list:
        """One engine decode step; returns next tokens aligned with seqs."""
        nxt = [0] * len(seqs)
        self.grid_rows = 0
        for g in self.groups:
            idx = [i for i, s in enumerate(seqs)
                   if self._group_of[s.model_id] is g]
            if idx:
                for i, t in zip(idx, g.step([seqs[i] for i in idx])):
                    nxt[i] = t
                self.grid_rows += g.grid_rows
        return nxt
