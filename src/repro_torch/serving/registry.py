"""Model-lifecycle registry: hot (un)register decode models while serving.

Port of ``repro.serving.registry`` for full-weight decode models (the
paper's full fine-tunes). LoRA specs arrive with the serving-features
slice.

    engine.models.register("planner", DecodeModelSpec(full=planner_params))
    engine.models.unregister("planner", drain=True)   # or drain=False

``register`` takes effect for new requests immediately; the fused decode
plane is rebuilt at the next STEP BOUNDARY (``sync``, called by the
scheduler at the top of every step), never mid-step. ``unregister
(drain=True)`` refuses new work at once and lets in-flight requests finish;
``drain=False`` aborts them through the engine's abort path.
"""
from __future__ import annotations

from typing import Any

from repro_torch.core.lora import check_stackable
from repro_torch.serving.api import UnknownModelError


class DecodeModelSpec:
    """How a registered decode model stores its weights: ``full=params``, a
    complete param tree that the fused plane stacks on its model axis."""

    def __init__(self, full: Any = None, lora: Any = None):
        if lora is not None:
            raise NotImplementedError(
                "LoRA decode models: port slice 4 (serving features)")
        if full is None:
            raise ValueError("DecodeModelSpec takes full=params")
        self.full = full

    def group_key(self):
        """Fusability bucket within one ModelConfig."""
        return ("full",)

    def __repr__(self):
        return "DecodeModelSpec(full=<params>)"


def as_spec(obj) -> DecodeModelSpec:
    """Coerce to a spec: raw param trees register as full models."""
    if isinstance(obj, DecodeModelSpec):
        return obj
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
        (``core.lora.check_stackable``). The engine's constructor registers
        its decoders first and then stacks the whole set once."""
        if self.engine.fused and self.engine.decode_plane is not None:
            check_stackable([s.full for s in specs])

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
