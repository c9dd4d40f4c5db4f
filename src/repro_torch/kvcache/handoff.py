"""Cache handoff: prefill worker -> decode worker (paper §3.3 step 3).

Port of ``repro.kvcache.handoff``. On the shared paged pool the handoff is
ZERO-COPY: the wire carries only a block-table reference (int32 page ids
plus a length/schema header); the KV pages never move. The engine times
every real handoff (refcounting plus the tail page's copy-on-write) and
feeds it to ``observe_paged``; ``plan_paged`` reports the EWMA of those wall
times, 0.0 before the first observation.

The dense fallback hands a COPY of the session cache to the decode model
(``transfer_cache``). ``plan`` prices such a copy between two cards, the
serving simulator's model: bytes over ``n_links`` links, with the
Appendix-B.2 staging penalty when the bytes exceed the decode side's free
device memory. ``quantize_cache`` compresses a cache to symmetric
per-channel int8 for that wire, bit for bit as the reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.prefillshare import CacheSchema
from repro_torch.kvcache.manager import kv_bytes_per_token, state_bytes_per_seq
from repro_torch.params import tree_leaves, tree_map


class SchemaMismatch(Exception):
    """Receiving decoder was not trained against this base prefill module."""


#: one NVLink 4 link of an H100 SXM, one way (GB/s): 18 links carry 900
#: GB/s both ways together per card (NVIDIA's data sheet), 25 GB/s each way
#: a link. A data-sheet figure: one card cannot measure a card-to-card link.
NVLINK_GBPS = 25.0
#: NVLink 4 links of one H100 SXM (same data sheet)
NVLINK_LINKS = 18


@dataclass
class HandoffPlan:
    bytes: int
    seconds: float
    staged: bool          # True if the staging penalty applied (B.2)


class HandoffChannel:
    """Handoff channel between prefill and decode: ``plan`` prices a dense
    cache copy over the link (analytic: the simulator's model),
    ``plan_paged`` reports the measured zero-copy handoff."""

    #: EWMA weight for measured handoff samples
    MEASURE_ALPHA = 0.2

    def __init__(self, cfg: ModelConfig, *, link_gbps: float = NVLINK_GBPS,
                 n_links: int = 1, staging_penalty: float = 4.0):
        self.cfg = cfg
        self.bw = link_gbps * 1e9 * n_links
        self.staging_penalty = staging_penalty
        self.measured_bytes = 0.0     # EWMA of observed paged-handoff bytes
        self.measured_s = 0.0         # EWMA of observed paged-handoff seconds
        self.samples = 0

    def plan(self, n_tokens: int, *, decode_hbm_free_bytes: int | None = None
             ) -> HandoffPlan:
        """A dense cache of ``n_tokens`` (KV bytes per token times tokens
        plus the constant per-sequence state) over the link; staged, at
        ``staging_penalty`` times the time, when the bytes exceed
        ``decode_hbm_free_bytes``."""
        b = kv_bytes_per_token(self.cfg) * n_tokens \
            + state_bytes_per_seq(self.cfg)
        staged = (decode_hbm_free_bytes is not None
                  and b > max(decode_hbm_free_bytes, 0))
        secs = b / self.bw * (self.staging_penalty if staged else 1.0)
        return HandoffPlan(bytes=b, seconds=secs, staged=staged)

    def observe_paged(self, nbytes: int, seconds: float) -> None:
        """Feed one MEASURED zero-copy handoff into the estimate."""
        self.samples += 1
        if self.samples == 1:
            self.measured_bytes = float(nbytes)
            self.measured_s = float(seconds)
        else:
            a = self.MEASURE_ALPHA
            self.measured_bytes += a * (nbytes - self.measured_bytes)
            self.measured_s += a * (seconds - self.measured_s)

    def estimate_paged_s(self) -> float:
        """Expected wall time of one zero-copy handoff (0.0 until the first
        handoff has been observed)."""
        return self.measured_s

    def plan_paged(self, n_pages: int) -> HandoffPlan:
        """The wire carries ONLY the block table: 4 bytes per page id plus a
        16-byte header; ``seconds`` is the measured EWMA."""
        b = 4 * n_pages + 16
        return HandoffPlan(bytes=b, seconds=self.measured_s, staged=False)

    @staticmethod
    def check(producer: CacheSchema, consumer_expected: CacheSchema) -> None:
        if not producer.compatible_with(consumer_expected):
            raise SchemaMismatch(
                f"cache from base {producer.base_model_id} cannot feed a "
                f"decoder trained against {consumer_expected.base_model_id}")


def transfer_cache(cache, device=None):
    """The dense handoff: a copy of the cache tree (``device=None``), or
    the tree moved to ``device``."""
    if device is None:
        return tree_map(lambda x: x.clone(), cache)
    return tree_map(lambda x: x.to(device), cache)


# ----------------------------------------------------------------------
# int8 handoff compression: symmetric per-channel int8 halves the wire
# bytes of a bf16 cache; the decode side dequantizes into its cache.


def _quantizable(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point() \
        and x.dim() >= 3


def quantize_cache(cache):
    """KV leaves (floating, ndim >= 3) -> ``{"q": int8, "scale": fp32 per
    channel (amax over axis -2), "dtype": name}``; other leaves pass
    through. Rounds half to even, as ``jnp.round``, so payload and scales
    equal the reference's bit for bit."""
    def q(x):
        if not _quantizable(x):
            return x
        xf = x.float()
        amax = xf.abs().amax(dim=-2, keepdim=True)
        scale = torch.clamp(amax, min=1e-8) / 127.0
        qv = torch.clamp(torch.round(xf / scale), -127, 127)
        return {"q": qv.to(torch.int8), "scale": scale,
                "dtype": str(x.dtype).removeprefix("torch.")}
    return tree_map(q, cache)


def _is_q(x) -> bool:
    return isinstance(x, dict) and set(x) == {"q", "scale", "dtype"}


def dequantize_cache(qcache):
    """Inverse of ``quantize_cache``: ``q * scale`` cast back to each
    leaf's dtype."""
    if _is_q(qcache):
        return (qcache["q"].float() * qcache["scale"]).to(
            getattr(torch, qcache["dtype"]))
    if isinstance(qcache, dict):
        return {k: dequantize_cache(v) for k, v in qcache.items()}
    if isinstance(qcache, (list, tuple)):
        return type(qcache)(dequantize_cache(v) for v in qcache)
    return qcache


def quantized_bytes(cache) -> int:
    """Wire bytes of the int8-compressed cache (payload plus scales)."""
    total = 0
    for leaf in tree_leaves(cache):
        if _quantizable(leaf):
            total += leaf.numel()                            # int8 payload
            total += (leaf.numel() // leaf.shape[-2]) * 4    # scales
        elif isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
    return total
