"""Operations and bytes the served work needs, from sizes alone.

Counted from what the inputs need, whatever kernel computes them:
  - a prefill token feeds the decoders only through its K/V, so it needs
    every layer but the last, the last layer's K and V projections, and
    attention in every layer but the last; no logits;
  - a decode token needs every layer, its attention over all earlier
    positions, and the unembedding;
  - attention at a query with ``t`` keys is 4 * t * heads * head_dim
    operations in one layer (scores and the weighted sum);
  - a kernel's least time over a stretch is the larger of all the bytes it
    must move over the HBM bandwidth and all the operations over the bf16
    peak: each K/V byte a row or a prompt reads is counted once, each
    query read once, each output written once;
  - a prompt's prefill is counted from the traffic alone: its length and
    the prefix the cache should serve (``traffic.Call.cached``), the same
    however the program chunks it. Its work is placed evenly over the
    engine steps from its send to its first token (``share``), so a
    stretch or a window holds the part of it that falls inside.

``hp`` is ``spec.hparams`` of the configuration; ``peaks`` an entry of
``servebench/peaks.json``.
"""
from __future__ import annotations

import bisect

ELEM_BYTES = 2                  # bf16 K/V, queries and outputs


def _layer_params(hp) -> int:
    d, hq, hkv, hd = hp["d_model"], hp["n_heads"], hp["n_kv_heads"], \
        hp["head_dim"]
    return 2 * d * hq * hd + 2 * d * hkv * hd + 3 * d * hp["d_ff"]


def decode_token_flops(hp) -> float:
    """Matrix-product operations of one decode token (no attention)."""
    return 2.0 * (hp["n_layers"] * _layer_params(hp)
                  + hp["vocab_size"] * hp["d_model"])


def prefill_token_flops(hp) -> float:
    """Matrix-product operations of one prefill token (no attention)."""
    kv = 2 * hp["d_model"] * hp["n_kv_heads"] * hp["head_dim"]
    return 2.0 * ((hp["n_layers"] - 1) * _layer_params(hp) + kv)


def attention_flops(hp, keys: int) -> float:
    """One query's attention in ONE layer over ``keys`` keys."""
    return 4.0 * keys * hp["n_heads"] * hp["head_dim"]


def causal_span_flops(hp, start: int, length: int) -> float:
    """Attention of queries at positions start..start+length-1 (each over
    itself and every earlier position), summed, in ONE layer."""
    keys = length * start + length * (length + 1) // 2
    return attention_flops(hp, keys)


def _kv_bytes(hp, tokens: int) -> float:
    return tokens * hp["n_kv_heads"] * hp["head_dim"] * 2 * ELEM_BYTES


def _qo_bytes(hp, rows: int) -> float:
    return 2 * rows * hp["n_heads"] * hp["head_dim"] * ELEM_BYTES


def _bound(flops: float, nbytes: float, peaks: dict) -> float:
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["bf16_flops_per_s"])


def share(steps, start: float, end: float, lo: float, hi: float) -> float:
    """The part of a prefill sent at ``start`` whose first token was
    pushed at ``end`` that falls in (``lo``, ``hi``]: of the engine steps
    from the first to end after the send to the one that pushed that
    token (``steps``: every step's end, in order), the share that ended in
    (``lo``, ``hi``]."""
    i0 = bisect.bisect_right(steps, start)
    i1 = min(bisect.bisect_left(steps, end), len(steps) - 1)
    if i1 < i0:
        return 0.0
    j0 = max(i0, bisect.bisect_right(steps, lo))
    j1 = min(i1, bisect.bisect_right(steps, hi) - 1)
    return max(0, j1 - j0 + 1) / (i1 - i0 + 1)


def prefills_in(reqs, steps, lo: float, hi: float) -> list:
    """``[(cached, new, part)]``: the part of each request's prefill that
    falls in (``lo``, ``hi``] (``share``), from its call and its send and
    first-token times (the end of a request that never had a token)."""
    out = []
    for r in reqs:
        end = r.first if r.first is not None else r.done
        if end is None:
            continue
        w = share(steps, r.submitted, end, lo, hi)
        if w > 0:
            out.append((r.call.cached, len(r.call.prompt) - r.call.cached,
                        w))
    return out


def decode_step_work(hp, rows) -> tuple[float, float]:
    """``(flops, bytes)`` of ``paged_decode`` over one decode step of every
    layer. ``rows``: the input positions decoded; a row at position p
    attends over p + 1 keys."""
    tokens = sum(p + 1 for p in rows)
    flops = sum(attention_flops(hp, p + 1) for p in rows)
    L = hp["n_layers"]
    return L * flops, L * (_kv_bytes(hp, tokens) + _qo_bytes(hp, len(rows)))


def prefill_work(hp, cached: int, new: int) -> tuple[float, float]:
    """``(flops, bytes)`` of ``flash_prefill_paged`` over one prompt's
    prefill, in every layer: its ``new`` queries after ``cached`` tokens,
    each over the prefix and the queries up to itself."""
    L = hp["n_layers"]
    return (L * causal_span_flops(hp, cached, new),
            L * (_kv_bytes(hp, cached + new) + _qo_bytes(hp, new)))


def decode_bound_s(hp, steps, peaks) -> float:
    """The least time ``paged_decode`` needs for ``steps`` (lists of rows,
    as ``decode_step_work`` takes them)."""
    work = [decode_step_work(hp, rows) for rows in steps]
    return _bound(sum(f for f, _ in work), sum(b for _, b in work), peaks)


def prefill_bound_s(hp, prefills, peaks) -> float:
    """The least time ``flash_prefill_paged`` needs for ``prefills``,
    ``[(cached, new, part)]``: the ``part`` of each prompt's prefill."""
    work = [(w, prefill_work(hp, c, n)) for c, n, w in prefills]
    return _bound(sum(w * f for w, (f, _) in work),
                  sum(w * b for w, (_, b) in work), peaks)


def served_flops(hp, prefills, rows) -> float:
    """Operations the served work needed: of each prompt's prefill,
    ``[(cached, new, part)]``, the ``part`` of its new tokens' matrix
    products and attention in the layers that need it; of each decoded
    row, its input position in ``rows``, the matrix products and the
    attention over its context."""
    L = hp["n_layers"]
    flops = sum(w * (n * prefill_token_flops(hp)
                     + (L - 1) * causal_span_flops(hp, c, n))
                for c, n, w in prefills)
    flops += sum(decode_token_flops(hp) + L * attention_flops(hp, p + 1)
                 for p in rows)
    return flops
