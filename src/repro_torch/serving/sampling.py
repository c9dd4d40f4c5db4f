"""Per-sequence token sampling for the decode planes.

Port of ``repro.serving.sampling``, with the reference's random numbers
reproduced bit for bit: the PRNG is jax's threefry2x32 (``PRNGKey``,
``fold_in`` and the partitionable ``random_bits`` of
``jax_threefry_partitionable=True``, the default), written here in torch
integer ops. Every 32-bit word lives in an int64 tensor masked to 32 bits,
so the same code runs on the CPU and on the card, with no unsigned dtype.

Two properties the tests pin, as in the reference:
  - ``temperature == 0`` is exactly ``argmax(logits)`` over the raw fp32
    logits, whatever else shares the batch;
  - the key for the token sampled at absolute position ``p`` of a request
    with seed ``s`` is ``fold_in(PRNGKey(s), p)``: a function of the request
    alone, never of the batch packing, the lane or the padding.

Filtering order: the top-k mask by rank, then the nucleus (top-p) over the
renormalized top-k survivors (a sorted entry stays while the mass strictly
before it is ``< top_p``), then temperature, then a Gumbel-max draw
(``jax.random.categorical``). ``top_k <= 0`` and ``top_p >= 1`` disable
their filters; the most probable token always survives.
"""
from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_F32_MIN = torch.finfo(torch.float32).min
_F32_TINY = torch.finfo(torch.float32).tiny


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """jax's ``threefry2x32_p``: 20 rounds of Threefry-2x32 on the words
    ``(x1, x2)`` under the key ``(k1, k2)``. Every argument is an int64
    tensor of 32-bit words (keys broadcast against the counters); returns
    the two output words, likewise."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def prng_key(seed):
    """``jax.random.PRNGKey`` of int32 seeds: ``(N,)`` -> ``(N, 2)`` words.
    An int32 seed has no high word (a logical shift by 32 gives 0) and its
    low word is the seed's two's-complement bits."""
    seed = torch.as_tensor(seed).long()
    return torch.stack([torch.zeros_like(seed), seed & _M32], -1)


def fold_in(key, data):
    """``jax.random.fold_in``: ``threefry2x32(key, (0, uint32(data)))``.
    key: ``(N, 2)``; data: ``(N,)`` int. Returns ``(N, 2)``."""
    data = torch.as_tensor(data, device=key.device).long() & _M32
    y1, y2 = threefry2x32(key[:, 0], key[:, 1], torch.zeros_like(data), data)
    return torch.stack([y1, y2], -1)


def random_bits(keys, n: int):
    """``jax.random.bits(key, (n,), uint32)`` for each row of ``keys``
    (``(N, 2)``), partitionable form: counter ``(hi, lo) = (0, i)`` for
    element ``i``, result ``y1 ^ y2``. Returns ``(N, n)`` int64 words."""
    lo = torch.arange(n, dtype=torch.int64, device=keys.device)[None]
    y1, y2 = threefry2x32(keys[:, :1], keys[:, 1:], torch.zeros_like(lo), lo)
    return y1 ^ y2


def uniform(keys, n: int, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, (n,), float32, minval, maxval)`` per row:
    the top 23 bits become the mantissa of a float in [1, 2), minus 1,
    scaled, then clamped below at ``minval``."""
    bits = (random_bits(keys, n) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=keys.device)
    span = (torch.tensor(maxval, dtype=torch.float32, device=keys.device)
            - lo)
    return torch.maximum(lo, floats * span + lo)


def gumbel(keys, n: int):
    """``jax.random.gumbel(key, (n,), float32)`` per row, mode "low":
    ``-log(-log(u))`` with ``u`` uniform in [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, n, _F32_TINY, 1.0)))


def categorical(keys, logits):
    """``jax.random.categorical(key, logits)`` per row: the Gumbel-max draw
    ``argmax(gumbel + logits)``. logits: ``(N, V)`` fp32."""
    return torch.argmax(gumbel(keys, logits.shape[-1]) + logits, -1)


def fold_keys(seeds, positions):
    """Per-sequence keys ``fold_in(PRNGKey(seed), pos)``: ``(N, 2)``.
    seeds/positions: ``(N,)`` int32 tensors. The key depends only on the
    request's own seed and the absolute position of the sampled token."""
    return fold_in(prng_key(seeds), positions)


def _softmax(x):
    """``jax.nn.softmax`` over the last axis: ``exp(x - max) / sum``."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def filter_logits(logits, temperature, top_k, top_p):
    """The scores the draw perturbs: the top-k mask by rank, the nucleus
    over the survivors, then temperature. Masked entries are the fp32
    minimum (scaled). logits: (N, V) fp32; the rest (N,)."""
    N, V = logits.shape
    logits = logits.float()
    iota = torch.arange(V, device=logits.device).expand(N, V)
    # top-k first: rank every vocab id (a stable sort, as jnp.argsort is),
    # mask those beyond the k-th
    sort_idx = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.empty_like(sort_idx).scatter_(-1, sort_idx, iota)
    k = torch.where(top_k > 0, torch.clamp(top_k, max=V), V).long()
    fk = torch.where(ranks < k[:, None], logits, _F32_MIN)
    # nucleus over the surviving (top-k-renormalized) distribution: a
    # sorted entry stays while the mass STRICTLY before it is < top_p
    fk_idx = torch.argsort(-fk, dim=-1, stable=True)
    probs = _softmax(torch.gather(fk, -1, fk_idx))
    cum = torch.cumsum(probs, -1)
    keep_sorted = (cum - probs) < top_p[:, None]
    keep = torch.empty_like(keep_sorted).scatter_(-1, fk_idx, keep_sorted)
    filtered = torch.where(keep, fk, _F32_MIN)
    return filtered / torch.clamp(temperature, min=1e-6)[:, None]


def sample_logits(logits, temperature, top_k, top_p, keys):
    """One token per row; greedy rows (temperature <= 0) are exact argmax
    over the RAW logits.

    logits: (N, V) fp32; temperature/top_p: (N,) fp32; top_k: (N,) int;
    keys: (N, 2) from ``fold_keys``. Returns (N,) int64."""
    greedy = torch.argmax(logits, -1)
    sampled = categorical(keys, filter_logits(logits, temperature, top_k,
                                              top_p))
    return torch.where(temperature <= 0.0, greedy, sampled)


def sample_step(logits, positions, temperature, top_k, top_p, seeds):
    """What the decode steps call: fold each row's key from (seed, position)
    and sample. Every argument is (N,)-aligned with ``logits`` rows."""
    return sample_logits(logits, temperature, top_k, top_p,
                         fold_keys(seeds, positions))
