"""Model-lifecycle registry: hot (un)register decode models while serving.

Port of ``repro.serving.registry``.

    engine.models.register("summarizer", DecodeModelSpec(
        lora=LoRAAdapter(params=lora_init(base, rank=8, generator=g))))
    engine.models.register("planner", DecodeModelSpec(full=planner_params))
    engine.models.unregister("planner", drain=True)   # or drain=False

``register`` takes effect for new requests immediately; the fused decode
plane is rebuilt at the next STEP BOUNDARY (``sync``, called by the
scheduler at the top of every step), never mid-step. ``unregister
(drain=True)`` refuses new work at once and lets in-flight requests finish;
``drain=False`` aborts them through the engine's abort path.

Weight layout per spec kind (serving/decode.py):
  - ``full=params``: the model's full tree joins the stacked model axis.
  - ``lora=LoRAAdapter(...)``: only the stacked A/B factors are stored; the
    frozen base weights are the ENGINE's single copy, and each lane's
    ``W + scale * A[m] @ B[m]`` is merged inside the fused step, one layer
    at a time (Eq. 9 on the weight side).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from repro_torch.core.lora import (check_layer_adapters, check_stackable,
                                   lora_apply)
from repro_torch.serving.api import UnknownModelError


@dataclass(frozen=True)
class LoRAAdapter:
    """An adapter-factored decode module: ``W_eff = W + (alpha/rank)·A@B``
    over the engine's frozen base weights. ``params`` is a ``lora_init``-
    style tree (``LoRAPair`` at targeted weights, None elsewhere)."""
    params: Any
    alpha: float = 16.0
    rank: int = 8

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


class DecodeModelSpec:
    """How a registered decode model stores its weights: exactly one of

    - ``full=params``: a complete param tree, stacked on the model axis;
    - ``lora=LoRAAdapter(...)``: base + low-rank factors; the fused plane
      stores only the stacked factors and merges inside the step.
    """

    def __init__(self, full: Any = None, lora: LoRAAdapter | None = None):
        if (full is None) == (lora is None):
            raise ValueError(
                "DecodeModelSpec takes exactly one of full=params or "
                "lora=LoRAAdapter(...)")
        if lora is not None and not isinstance(lora, LoRAAdapter):
            raise TypeError(f"lora= expects a LoRAAdapter, got {type(lora)}")
        self.full = full
        self.lora = lora

    @property
    def kind(self) -> str:
        return "full" if self.full is not None else "lora"

    def group_key(self):
        """Fusability bucket within one ModelConfig: full models stack with
        full models; adapters only with adapters of the same (alpha, rank),
        whose stacked A/B shapes and merge scale agree."""
        if self.full is not None:
            return ("full",)
        return ("lora", self.lora.alpha, self.lora.rank)

    def materialize(self, base_params):
        """Full effective params (the per-model ``fused=False`` layout)."""
        if self.full is not None:
            return self.full
        return lora_apply(base_params, self.lora.params,
                          alpha=self.lora.alpha, rank=self.lora.rank)

    def __repr__(self):
        if self.full is not None:
            return "DecodeModelSpec(full=<params>)"
        return (f"DecodeModelSpec(lora=LoRAAdapter(rank={self.lora.rank}, "
                f"alpha={self.lora.alpha}))")


def as_spec(obj) -> DecodeModelSpec:
    """Coerce to a spec: raw param trees register as full models."""
    if isinstance(obj, DecodeModelSpec):
        return obj
    if isinstance(obj, LoRAAdapter):
        return DecodeModelSpec(lora=obj)
    return DecodeModelSpec(full=obj)


class ModelRegistry:
    """The engine's decode-model set, mutable while serving.

    Mutations take effect for bookkeeping immediately (new requests validate
    against the registry the moment ``register``/``unregister`` returns);
    the fused plane's stacked layout is rebuilt by ``sync()`` at step
    boundaries only."""

    def __init__(self, engine):
        self.engine = engine
        self._specs: dict[str, DecodeModelSpec] = {}
        self._draining: set[str] = set()
        self._dirty = False        # plane layout stale (rebuild at sync)

    # -- queries -------------------------------------------------------
    def list(self) -> list[str]:
        """Registered model ids (draining models included until retired)."""
        return sorted(self._specs)

    def get(self, model_id: str) -> DecodeModelSpec:
        self._check_known(model_id)
        return self._specs[model_id]

    def __contains__(self, model_id) -> bool:
        return model_id in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    def __iter__(self):
        return iter(self.list())

    @property
    def draining(self) -> frozenset:
        return frozenset(self._draining)

    def _check_known(self, model_id: str) -> None:
        if model_id not in self._specs:
            raise UnknownModelError(
                f"model {model_id!r} is not registered "
                f"(registered: {self.list() or 'none'}); add it with "
                f"engine.models.register(model_id, DecodeModelSpec(...))")

    def check_serving(self, model_id: str) -> None:
        """Validate a model id for NEW work."""
        self._check_known(model_id)
        if model_id in self._draining:
            raise UnknownModelError(
                f"model {model_id!r} is draining (unregister pending): it "
                f"accepts no new requests; in-flight ones will finish")

    # -- mutations -----------------------------------------------------
    def register(self, model_id: str, spec) -> None:
        """Add a decode model while serving; its fused-plane lane appears at
        the next step boundary."""
        if model_id in self._specs:
            state = "draining" if model_id in self._draining else "registered"
            raise ValueError(
                f"model {model_id!r} is already {state}; unregister it "
                f"(and let it drain) before re-registering")
        spec = as_spec(spec)
        self._check_layout([*self._specs.values(), spec])
        self.engine._attach_decoder(model_id, spec)
        self._specs[model_id] = spec
        self._dirty = True
        self.engine.stats.model_churn_events += 1

    def unregister(self, model_id: str, *, drain: bool = True) -> bool:
        """Retire a decode model. Returns True if it is fully gone on
        return, False if it is draining."""
        self._check_known(model_id)
        if model_id in self._draining:
            raise ValueError(f"model {model_id!r} is already draining")
        self._check_layout([s for m, s in self._specs.items()
                            if m != model_id])
        self.engine.stats.model_churn_events += 1
        if not drain:
            for rid in self.engine._inflight_rids(model_id):
                self.engine.abort(rid)
        if self.engine._has_inflight(model_id):
            self._draining.add(model_id)
            return False
        self._finalize(model_id)
        return True

    def _check_layout(self, specs) -> None:
        """Refuse, before any state changes, a model set that the live fused
        plane could stack only by copying rows of a stacked tree
        (``core.lora.check_stackable``; full specs only: adapters are
        stacked as copies of their small factors), or adapters it cannot
        merge in its step (``check_layer_adapters``). The engine's
        constructor registers its decoders first and then stacks the whole
        set once."""
        if not self.engine.fused:
            return
        for s in specs:
            if s.lora is not None:
                check_layer_adapters(s.lora.params)
        if self.engine.decode_plane is not None:
            check_stackable([s.full for s in specs if s.full is not None])

    # -- step-boundary application --------------------------------------
    def sync(self) -> None:
        """Apply deferred mutations; called by the scheduler at the top of
        every step. No-op when clean."""
        for model_id in sorted(self._draining):
            if not self.engine._has_inflight(model_id):
                self._draining.discard(model_id)
                self._finalize(model_id)
        if self._dirty:
            self.engine._rebuild_decode_plane()
            self._dirty = False

    def _finalize(self, model_id: str) -> None:
        del self._specs[model_id]
        self.engine._detach_decoder(model_id)
        self._dirty = True

    def __repr__(self):
        drain = f", draining={sorted(self._draining)}" if self._draining else ""
        return f"ModelRegistry({self.list()}{drain})"
