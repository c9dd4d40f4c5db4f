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
  - sequences are bucketed per model into an (M, bucket) grid, ``bucket``
    the next power of two of the most rows any model has; padding rows
    carry block tables of sentinel page 0 (never allocated);
  - block-table width is bucketed to the next power of two too, so the
    shapes a step sees grow O(log) with batch and context;
  - projections and the MLP are matrix products over the model axis, and
    attention is ONE ``paged_decode`` launch per layer over the flattened
    M * bucket batch (``models.model.decode_stacked``);
  - every real row writes its K/V straight into the shared pool. That is
    exact: written pages are private per sequence. The step passes the
    forward a fixed-length list of M * bucket row indices: the real rows'
    flat indices in ``seqs`` order, then the first of them repeated, so a
    padding position rewrites that row's slot with the same bytes and
    sentinel page 0 stays zero, as in the reference. ``grid_rows`` keeps
    the last step's M * bucket, padding included (the ``engine.step``
    span's attribute).

On the card a full-weight group (dense or MoE: a decode row routes one
token, so every shape is static) replays its forward from a CUDA graph,
one per (bucket, npages) key: captured on the key's first sight, after an
eager forward on a side stream that gives that step its tokens and warms
the key's kernels, into one memory pool that all the group's graphs share
(they replay one after another, and each step consumes its logits before
the next replay). A graph owns its inputs, one int32 buffer on the card
refilled from a pinned host copy, and its fp32 logits. LoRA groups merge
their lanes per layer and run the same bucketed step eagerly, as does the
CPU. A plane rebuilt by churn starts with no graphs.

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
from repro_torch.kernels.paged_decode import paged_decode_attention
from repro_torch.kernels.paged_write import paged_write
from repro_torch.models import decode_stacked
from repro_torch.params import tree_leaves
from repro_torch.serving.metrics import NULL_SPANS, SPAN_READBACK
from repro_torch.serving.sampling import sample_step


#: kernel wrappers that count their launches in Python (``.launches``): a
#: graph's replay adds what its capture counted
COUNTED_KERNELS = (paged_decode_attention, paged_write)


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (>= 1): the batch and block-table width
    bucket."""
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
        self.grid_rows = 0                        # the last step's M*bucket
        self.spans = spans
        # CUDA graphs of the forward, one per (bucket, npages) key: a
        # full-weight group on the card (``capture`` is replaceable, so the
        # CPU tests drive the key cache with a stand-in)
        self.graphed = kvpool.device.type == "cuda" and not self.lora
        self._graphs: dict = {}
        self._pool = None
        self.graph_captures = 0
        self.graph_replays = 0

    def param_bytes(self) -> int:
        """Bytes of decode weights this group stores beyond the engine's
        base copy: the stacked trees of a full group, the stacked A/B
        factors only of a LoRA group (the base is shared, not copied)."""
        tree = self.stacked["ab"] if self.lora else self.stacked
        return sum(x.nbytes for x in tree_leaves(tree))

    def capture(self, forward):
        """Capture ``forward()``, a fused forward over one key's static
        inputs, into a CUDA graph of the group's shared memory pool;
        returns (replay, logits). A capture runs nothing on the card."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            logits = forward()
        return graph.replay, logits

    def _forward(self, inputs, bucket: int, npages: int):
        """The fused forward over ``inputs`` (``_Inputs``' layout, on the
        pool's device): (M, bucket, V) fp32 logits."""
        toks, pos, rows, bts = _Inputs.views(inputs, len(self.model_ids),
                                             bucket, npages)
        k_layers, v_layers = self.kvpool.layers()
        return decode_stacked(self.cfg, self.stacked, toks, pos, k_layers,
                              v_layers, bts, rows=rows, lanes=self._lanes)

    def _first_sight(self, key, host, inputs):
        """A graphed group's first step at ``key``: the eager forward, on a
        side stream on the card (this step's logits, and the warm-up a
        capture needs), then the key's graph over the same inputs. Launches
        counted in Python count the eager forward; a capture launches
        nothing, so its counts are kept for its replays."""
        forward = partial(self._forward, inputs, *key)
        dev = self.kvpool.device
        if dev.type == "cuda":
            side, main = torch.cuda.Stream(dev), torch.cuda.current_stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                logits = forward()
            main.wait_stream(side)
            logits.record_stream(main)
        else:
            logits = forward()
        before = [fn.launches for fn in COUNTED_KERNELS]
        replay, out = self.capture(forward)
        launches = []
        for fn, n in zip(COUNTED_KERNELS, before):
            launches.append((fn, fn.launches - n))
            fn.launches = n
        self._graphs[key] = _Graph(host, inputs, replay, out, launches)
        self.graph_captures += 1
        return logits

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
        key = (next_pow2(max(counts)),
               next_pow2(max(len(s.block_table) for s in seqs)))
        self.grid_rows = M * key[0]
        graph = self._graphs.get(key)
        dev = self.kvpool.device
        if graph is not None:
            graph.host.fill(seqs, coords)
            graph.inputs.copy_(graph.host.tensor, non_blocking=True)
            graph.replay()
            for fn, n in graph.launches:
                fn.launches += n
            self.graph_replays += 1
            inputs, logits = graph.inputs, graph.logits
        else:
            host = _Inputs(M, *key, pinned=self.graphed and dev.type == "cuda")
            host.fill(seqs, coords)
            inputs = host.tensor.to(dev)
            logits = (self._first_sight(key, host, inputs) if self.graphed
                      else self._forward(inputs, *key))
        self.dispatches += 1
        # the real rows' flat indices, in ``seqs`` order, lead the rows
        rows = _Inputs.views(inputs, M, *key)[2][:len(seqs)]
        lg = logits.reshape(self.grid_rows, -1).index_select(0, rows)
        return read_back(lg, seqs, dev, self.spans)


class _Inputs:
    """The fused forward's inputs as ONE int32 buffer on the host: tokens
    and positions (M, bucket), the rows that write the pool (M * bucket)
    and the block tables (M * bucket, npages), zero where padding. Pinned
    where it refills a graph's inputs: the refill is an asynchronous copy,
    which the step's token read-back has waited for before the next step
    writes the buffer again."""

    def __init__(self, M: int, bucket: int, npages: int, pinned: bool):
        self.shape = (M, bucket, npages)
        self.tensor = torch.zeros(M * bucket * (3 + npages),
                                  dtype=torch.int32, pin_memory=pinned)

    @staticmethod
    def views(buf, M: int, bucket: int, npages: int):
        """(toks (M, bucket), pos (M, bucket), rows (M * bucket,), bts
        (M * bucket, npages)): views of a buffer in this layout (a tensor
        or its numpy array)."""
        n = M * bucket
        return (buf[:n].reshape(M, bucket), buf[n:2 * n].reshape(M, bucket),
                buf[2 * n:3 * n], buf[3 * n:].reshape(n, npages))

    def fill(self, seqs, coords) -> None:
        """Write a step's inputs: each real row at its grid place (m, b) of
        ``coords``; the pad positions of the rows repeat the first real
        row's index, so they rewrite its slot with its own bytes."""
        arr = self.tensor.numpy()
        arr.fill(0)
        M, bucket, npages = self.shape
        toks, pos, rows, bts = self.views(arr, M, bucket, npages)
        for i, (s, (m, b)) in enumerate(zip(seqs, coords)):
            r = m * bucket + b
            toks[m, b] = s.next_token
            pos[m, b] = s.pos
            rows[i] = r
            bts[r, :len(s.block_table)] = s.block_table
        rows[len(seqs):] = rows[0]


class _Graph:
    """One key's captured forward: the pinned host buffer and the inputs on
    the card it refills, the replay, its logits, and the kernel launches
    (wrapper, count) that each replay makes."""

    def __init__(self, host, inputs, replay, logits, launches):
        self.host, self.inputs = host, inputs
        self.replay, self.logits, self.launches = replay, logits, launches


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

    @property
    def graph_replays(self) -> int:
        """Fused forwards of this plane replayed from a CUDA graph."""
        return sum(g.graph_replays for g in self.groups)

    @property
    def graph_captures(self) -> int:
        """CUDA graphs this plane captured (one per group and key)."""
        return sum(g.graph_captures for g in self.groups)

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
