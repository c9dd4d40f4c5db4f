"""Request-centric serving API: the engine's public surface.

The paper's execution pattern — N task-specific models invoked over ONE
shared prompt — is what this module makes the API's main verb:

    with engine.shared_context(system_tokens) as ctx:
        outs = [ctx.generate(agent, params=SamplingParams(max_tokens=32))
                for agent in ("planner", "coder", "reviewer")]
        for out in outs:
            for tok in out:          # streams while the engine runs
                ...

Pieces:
  - ``SamplingParams``: per-request decoding controls (temperature / top_k /
    top_p / seed / max_tokens / stop & EOS ids). The port serves
    ``temperature=0`` (exact greedy argmax) so far; the engine refuses
    ``temperature > 0`` until the sampling slice lands.
  - ``RequestOutput``: a live handle. Tokens stream in as the engine steps —
    iterate it (drives the engine), register callbacks, or call ``result()``
    to drive to completion. Carries the finish reason (eos/stop/length/
    abort) and per-token timestamps (TTFT / inter-token latencies).
  - ``SharedContext``: a first-class shared prefix replacing raw session
    ids: one prefilled prefix that many ``ctx.generate(model_id, tail)``
    calls attach to, released on ``close()``/context-manager exit.
  - ``engine.abort(request)``: cancels a request and returns every page
    refcount to baseline.
  - ``engine.models`` (``repro_torch.serving.registry``): the decode-model set as
    a live lifecycle surface — ``register``/``unregister`` while serving;
    requests naming a model the registry does not serve raise the
    first-class ``UnknownModelError`` defined here.

Port of ``repro.serving.api`` (copied; the legacy ``submit``/``invoke``
shims are not ported).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

#: finish reasons a request can end with
FINISH_EOS = "eos"          # the request's eos_token_id was generated
FINISH_STOP = "stop"        # a stop_token_ids member was generated
FINISH_LENGTH = "length"    # max_tokens reached
FINISH_ABORT = "abort"      # engine.abort() cancelled the request


class UnknownModelError(KeyError):
    """A request named a decode model the engine's ``ModelRegistry`` does not
    currently serve — never registered, already unregistered, or draining
    (unregister pending, accepting no new work). Raised by ``generate`` /
    ``SharedContext.generate`` / the legacy ``submit`` shim BEFORE any pages
    are touched, so a failed submission holds no engine state."""


@dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding controls.

    ``temperature=0`` (default) is exact greedy decoding — bit-identical to
    the pre-redesign path. ``top_k <= 0`` and ``top_p >= 1`` disable their
    filters. ``seed`` controls reproducibility: the PRNG key for each
    generated token folds from (seed, absolute position), so a stream never
    depends on what else is batched alongside the request. ``seed=None``
    (default) lets the engine assign a distinct per-request seed — N sampled
    fan-outs over one prompt give N different draws; pass an explicit seed
    to reproduce a stream across runs. ``max_tokens=0`` is a prefill-only
    request (used by SharedContext to warm a prefix). The terminating
    eos/stop token IS included in the output.

    ``priority`` ranks the request for admission ordering (the scheduler's
    ``priority`` policy) AND for oversubscription: with preemption armed
    (``LocalDisaggEngine(preempt=True)``), lower-priority decodes are
    swapped out or dropped-and-recomputed to unblock higher-priority work.
    Higher values are more important; the ``priority=`` kwarg on
    ``generate()`` overrides a nonzero value here."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int | None = None
    max_tokens: int = 16
    stop_token_ids: tuple = ()
    eos_token_id: int | None = None
    priority: int = 0

    def __post_init__(self):
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if not 0 < self.top_p <= 1:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_tokens < 0:
            raise ValueError(f"max_tokens must be >= 0, got {self.max_tokens}")
        if not isinstance(self.priority, int) or isinstance(self.priority,
                                                            bool):
            raise ValueError(
                f"priority must be an int, got {self.priority!r}")

    def is_stop(self, token: int) -> str | None:
        """Finish reason if ``token`` terminates the stream, else None."""
        if self.eos_token_id is not None and token == self.eos_token_id:
            return FINISH_EOS
        if token in self.stop_token_ids:
            return FINISH_STOP
        return None


class RequestOutput:
    """Live handle for one generation request.

    The engine pushes tokens into it as decode steps complete; consume them
    by iterating (drives the engine until the next token or finish), through
    ``add_callback``, or with ``result()`` (drives to completion). Timing:
    ``ttft`` and ``inter_token_latencies()`` are measured at token-push time,
    so they reflect what a streaming client would observe."""

    def __init__(self, engine, request_id: int, session_id, model_id: str,
                 params: SamplingParams):
        self.engine = engine
        self.request_id = request_id
        self.session_id = session_id
        self.model_id = model_id
        self.params = params
        self.tokens: list[int] = []
        self.finished = False
        self.finish_reason: str | None = None
        self.submit_time = time.perf_counter()
        self.first_token_time: float | None = None
        self.token_times: list[float] = []
        self._callbacks: list = []

    # -- engine side ---------------------------------------------------
    def _push(self, token: int) -> None:
        now = time.perf_counter()
        if self.first_token_time is None:
            self.first_token_time = now
        self.tokens.append(int(token))
        self.token_times.append(now)
        for cb in self._callbacks:
            cb(self, int(token))

    def _mark_finished(self, reason: str) -> None:
        self.finished = True
        self.finish_reason = reason

    # -- client side ---------------------------------------------------
    def add_callback(self, cb) -> "RequestOutput":
        """Register ``cb(request_output, token)``, fired per streamed token
        (already-streamed tokens are replayed immediately)."""
        for t in self.tokens:
            cb(self, t)
        self._callbacks.append(cb)
        return self

    @property
    def ttft(self) -> float | None:
        """Seconds from submission to the first streamed token."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.submit_time

    def inter_token_latencies(self) -> list[float]:
        """Gaps between consecutive streamed tokens, in seconds."""
        return [b - a for a, b in zip(self.token_times, self.token_times[1:])]

    def __iter__(self):
        """Stream tokens, stepping the engine whenever none are buffered."""
        i = 0
        while True:
            while i < len(self.tokens):
                yield self.tokens[i]
                i += 1
            if self.finished:
                return
            if not self.engine.scheduler.has_work():
                raise RuntimeError(
                    f"request {self.request_id}: engine idle but request "
                    f"unfinished")
            self.engine.step()

    def result(self) -> np.ndarray:
        """Drive the engine until this request finishes; returns the full
        token array (partial if the request was aborted — check
        ``finish_reason``)."""
        for _ in self:
            pass
        return np.asarray(self.tokens, np.int32)

    def abort(self) -> bool:
        """Cancel this request; see ``LocalDisaggEngine.abort``."""
        return self.engine.abort(self)

    def __repr__(self):
        state = self.finish_reason if self.finished else "running"
        return (f"RequestOutput(rid={self.request_id}, model={self.model_id!r}, "
                f"tokens={len(self.tokens)}, {state})")


class SharedContext:
    """A first-class shared prefix: the paper's one-prompt-many-models
    execution pattern as an API object.

    Owns an engine session id internally (no raw sid bookkeeping for the
    caller): the prefix is prefilled once (on entry, unless ``prefill=False``)
    and every ``generate`` attaches a decode model to it, reusing the
    resident pages via the session/radix fast paths. ``extend`` grows the
    prefix across turns (append-only, matching the engine's context rule);
    ``close``/context-manager exit releases the session's pages."""

    def __init__(self, engine, prefix_tokens=(), *, prefill: bool = True):
        self.engine = engine
        self.session_id = engine._new_context_sid()
        self.tokens = [int(t) for t in np.asarray(prefix_tokens)]
        self._closed = False
        if prefill and self.tokens:
            self.prefill()

    # ------------------------------------------------------------------
    def prefill(self) -> None:
        """Ensure the current prefix is resident in the KV pool (a
        prefill-only request: max_tokens=0, no decode model attached)."""
        assert not self._closed, "context is closed"
        self.engine._prefill_context(self.session_id, self.tokens)

    def extend(self, tokens) -> "SharedContext":
        """Append tokens to the shared prefix (observations, tool output,
        previous agents' generations). Lazy: the extension is prefilled by
        the next ``generate``/``prefill`` call."""
        assert not self._closed, "context is closed"
        self.tokens += [int(t) for t in np.asarray(tokens)]
        return self

    def generate(self, model_id: str, prompt_tail=(),
                 params: SamplingParams | None = None, *, priority: int = 0,
                 stream_callback=None) -> RequestOutput:
        """Attach decode model ``model_id`` to the shared prefix (plus an
        optional request-private ``prompt_tail``) and return its streaming
        handle. The tail does NOT join the shared prefix."""
        assert not self._closed, "context is closed"
        toks = self.tokens + [int(t) for t in np.asarray(prompt_tail)]
        return self.engine.generate(model_id, toks, params,
                                    session=self.session_id,
                                    priority=priority,
                                    stream_callback=stream_callback)

    def close(self) -> None:
        """Release the session's pages (refcount -> CACHED, LRU-reusable).
        In-flight requests keep their own page references and finish
        normally; abort them explicitly if their output is unwanted."""
        if not self._closed:
            self._closed = True
            self.engine.end_session(self.session_id)

    def __enter__(self) -> "SharedContext":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __repr__(self):
        state = "closed" if self._closed else "open"
        return (f"SharedContext(sid={self.session_id}, "
                f"prefix={len(self.tokens)} tok, {state})")
