"""One run of one cell: build, set up, measure a window, hand back samples.

The system under test is the port's ``LocalDisaggEngine`` in chunked mode:
the prefix cache, the zero-copy handoff, the fused decode plane, a frozen
base model and the configuration's decoders (full weights, rows of one
stacked tree). Requests enter through ``generate`` and advance through
``step()``; each request's token times are the engine's own push times
(``RequestOutput.token_times``, taken after the token read-back).

Set-up (counted in ``setup_s``): the weights, the engine, then the
traffic's layout (``traffic.Traffic.start``): the sessions' earlier
contexts prefilled, each client's first call sent with its answer cut to
an even spread of lengths, and the loop run until every one of those has
finished. By then the in-flight requests stand at every decode position,
every shape the window uses has run, and the kernels are loaded.

The window (``seconds`` long, closing at the first step end past it): a
free client takes the call that became available first (a new session when
none is) and sends it at once. After the window the loop keeps its load
until every request sent inside it has finished (the drain), so the tails
count every one of them. A traced run profiles a fixed stretch of the
window (``devtrace``); end-to-end numbers come from untraced runs.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import time
from dataclasses import dataclass, field

import torch

from benchlib import devtrace
from benchlib import spec as spec_mod
from benchlib import traffic as traffic_mod
from benchlib import weights as weights_mod

COUNTERS = ("prefill_tokens_computed", "prefill_tokens_reused",
            "decode_tokens", "decode_steps")
#: where the traced stretch starts (share of the window) and its length
TRACE_AT = 0.4
TRACE_S = 3.0
#: steps run under the profiler before the stretch opens
PROFILER_WARM_STEPS = 2
#: traced stretches a run may take before it keeps a trace that lost work
TRACE_TRIES = 3
#: the longest drain, in seconds, before the run gives up on a request
DRAIN_LIMIT_S = 120.0


@dataclass
class Req:
    """One request as its client saw it."""
    call: object                  # traffic.Call
    client: int
    submitted: float
    handle: object = None
    first: float | None = None    # the first token's push
    done: float | None = None
    times: list = field(default_factory=list)
    tokens: list = field(default_factory=list)
    failed: bool = False
    window: bool = False          # sent inside the window
    cut: bool = False             # a set-up call, its answer cut


@dataclass
class Result:
    setup_s: float
    w0: float
    w1: float
    requests: list                # Req sent inside the window
    all_reqs: list                # every Req of the run
    counters_window: dict
    counters_sub: dict | None
    sub: tuple | None             # profiled stretch (start, stop), host
    profiled: tuple | None        # the profiler on to off, warm-up in
    counters_outside: dict        # window deltas outside ``profiled``
    steps_sub: list               # per traced step: decode positions
    step_s: list                  # eng.step() seconds, window, untraced
    step_ends: list               # every eng.step()'s end, in order
    dtrace: object                # devtrace.DeviceTrace of the stretch
    trace_tries: int
    memory_peak_bytes: int
    weights: tuple                # (base, [decoder trees])
    steps: int = 0
    expected_reused: int = 0      # what the traffic says the cache serves


def _no_span(name: str):
    return contextlib.nullcontext()


def _counters(eng) -> dict:
    return {k: getattr(eng.stats, k) for k in COUNTERS}


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


class Loop:
    """Closed-loop clients over one engine."""

    def __init__(self, eng, traffic, first_token: int):
        self.eng, self.traffic = eng, traffic
        self.first_token = first_token
        self.model_ids = [f"m{m}" for m in range(traffic.n_models)]
        self.inflight: list[Req] = []
        self.avail = collections.deque()   # (session, index) in order
        self.free = []                     # clients waiting to send
        self.all_reqs: list[Req] = []
        self.in_window = False
        self.step_ends: list[float] = []
        #: a span around each ``generate``: the profiler's while it traces
        self.record = _no_span

    def step(self) -> tuple[float, float]:
        """One engine step; its start and end on the host's clock."""
        t0 = time.perf_counter()
        self.eng.step()
        t1 = time.perf_counter()
        self.step_ends.append(t1)
        return t0, t1

    def send(self, client: int, session, index: int,
             max_tokens: int | None = None) -> Req:
        from repro_torch.serving import SamplingParams
        call = session.call(index)
        n = call.gen if max_tokens is None else max_tokens
        r = Req(call, client, time.perf_counter(), window=self.in_window,
                cut=max_tokens is not None)
        with self.record(devtrace.GENERATE):
            r.handle = self.eng.generate(
                self.model_ids[call.model], call.prompt,
                SamplingParams(max_tokens=n), session=session.sid,
                first_token=self.first_token)
        self.inflight.append(r)
        self.all_reqs.append(r)
        return r

    def prefill(self, session, tokens) -> object:
        """A set-up request that makes ``tokens`` the session's committed
        context (one token decoded, not kept)."""
        from repro_torch.serving import SamplingParams
        return self.eng.generate(self.model_ids[0], tokens,
                                 SamplingParams(max_tokens=1),
                                 session=session.sid,
                                 first_token=self.first_token)

    def dispatch(self) -> None:
        """Every free client sends the call that became available first,
        opening a new session when none is."""
        while self.free:
            client = self.free.pop(0)
            if not self.avail:
                t = self.traffic.open()
                self.avail.append((t, t.next))
            session, i = self.avail.popleft()
            self.send(client, session, i)

    def poll(self) -> None:
        """What the last step delivered: finished requests make their
        session's next call available and free their clients."""
        still = []
        for r in self.inflight:
            h = r.handle
            if r.first is None and h.token_times:
                r.first = h.token_times[0]
            if not h.finished:
                still.append(r)
                continue
            r.times, r.tokens = h.token_times, h.tokens
            r.done = r.times[-1] if r.times else time.perf_counter()
            r.failed = h.finish_reason == "abort" or not r.tokens
            r.handle = None
            session = r.call.session
            self.avail.extend((session, i) for i in session.on_finish(
                r.call.index, r.tokens, r.call.gen if r.cut else 0))
            if session.done:
                self.eng.end_session(session.sid)
            self.free.append(r.client)
        self.inflight = still


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Result:
    from repro_torch.core.lora import unstack_params
    from repro_torch.serving import LocalDisaggEngine
    from torch.profiler import ProfilerActivity, profile, record_function
    cfg = spec_mod.model_config(cell.config)
    ecfg = cell.config["engine"]
    n_models = int(ecfg["decoders"])
    base, stacked = weights_mod.build(cfg, seed, n_models, device,
                                      float(cell.config["output_scale"]))
    decs = unstack_params(stacked, n_models)
    del stacked
    eng = LocalDisaggEngine(
        cfg, base, {f"m{m}": d for m, d in enumerate(decs)}, device=device,
        num_pages=int(ecfg["num_pages"]), page_size=int(ecfg["page_size"]),
        chunked=True, chunk_size=int(ecfg["chunk_size"]),
        token_budget=int(ecfg["token_budget"]), prefix_cache=True)
    clients = int(cell.params["clients"])
    traffic = traffic_mod.Traffic(cell.traffic, clients=clients,
                                  vocab=cfg.vocab_size, n_models=n_models,
                                  seed=seed,
                                  page_size=int(ecfg["page_size"]))
    loop = Loop(eng, traffic, int(ecfg["first_token"]))

    def step_until(cond, what: str) -> None:
        for _ in range(1_000_000):
            if cond():
                return
            loop.step()
            loop.poll()
            loop.dispatch()
        raise RuntimeError(f"set-up: {what} did not complete")

    # -- set-up: earlier contexts, then every client's cut first call --
    prefill, first = traffic.start()
    hs = [loop.prefill(t, ctx) for t, ctx in prefill]
    step_until(lambda: all(h.finished for h in hs), "the histories")
    for c, (session, i, n) in enumerate(first):
        loop.send(c, session, i, n)
    step_until(lambda: all(r.done is not None for r in loop.all_reqs
                           if r.cut), "the first calls")
    if trace:
        # the profiler's first start loads and initialises its tracer (on
        # the card, CUPTI): pay it here, in set-up, not in the window
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            loop.step()
            loop.poll()
            loop.dispatch()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    # the set-up's objects live as long as the run: keep them out of the
    # collector's passes in the window
    gc.collect()
    gc.freeze()

    # -- the window -----------------------------------------------------
    # a traced run: "wait" until the stretch is due, "warm" through the
    # profiler's first steps (they pay its start-up and no metric reads
    # them), "stretch" while the annotated steps run, then "done"; a trace
    # that lost its device work (``devtrace.consistent``) is taken again
    # later in the window while there is room
    w0 = time.perf_counter()
    setup_s = w0 - t_start
    c0 = _counters(eng)
    loop.in_window = True
    stage = "wait" if trace else "off"
    trace_at, stretch_s = TRACE_AT * seconds, min(TRACE_S, 0.25 * seconds)
    prof = sub = c_sub = profiled = dtrace = None
    tries = warm = 0
    steps_sub, step_s = [], []
    while True:
        loop.dispatch()
        if stage == "wait" and time.perf_counter() - w0 >= trace_at:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            if profiled is None:
                profiled = [time.perf_counter(), None]
                c_prof0 = _counters(eng)
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.__enter__()
            stage, warm = "warm", PROFILER_WARM_STEPS
        if stage == "warm" and warm == 0:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            win_rec = record_function(devtrace.WINDOW)
            win_rec.__enter__()
            loop.record = record_function
            sub = [time.perf_counter(), None]
            c_sub0 = _counters(eng)
            stage, steps_sub, longest = "stretch", [], 0.0
        if stage == "stretch":
            before = {id(r): len(r.handle.token_times)
                      for r in loop.inflight}
            with record_function(devtrace.STEP):
                t0, t1 = loop.step()
            longest = max(longest, t1 - t0)
            steps_sub.append([
                len(r.call.prompt) + before[id(r)] for r in loop.inflight
                if id(r) in before
                and len(r.handle.token_times) > before[id(r)]])
        else:
            t0, t1 = loop.step()
            if stage == "warm":
                warm -= 1
            else:
                step_s.append(t1 - t0)
        loop.poll()
        if stage == "stretch" and (t1 - sub[0] >= stretch_s
                                   or t1 - w0 >= seconds):
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            win_rec.__exit__(None, None, None)
            c_sub = _delta(c_sub0, _counters(eng))
            sub[1] = time.perf_counter()
            # the profiler's exit and the reduction stall the loop: outside
            # the stretch, inside the profiled time
            prof.__exit__(None, None, None)
            loop.record = _no_span
            dtrace = devtrace.reduce(prof)
            prof, tries = None, tries + 1
            profiled[1] = time.perf_counter()
            c_prof = _delta(c_prof0, _counters(eng))
            room = seconds - (profiled[1] - w0)
            stage = "done"
            if tries < TRACE_TRIES and room > 2 * stretch_s and \
                    not devtrace.consistent(dtrace, longest):
                stage, trace_at = "wait", 0.0
        if t1 - w0 >= seconds:
            break
    if prof is not None:                     # the window ended first
        prof.__exit__(None, None, None)
        prof = None
        profiled[1] = time.perf_counter()
        c_prof = _delta(c_prof0, _counters(eng))
    w1 = t1
    counters_window = _delta(c0, _counters(eng))
    counters_outside = dict(counters_window)
    if profiled is not None:
        for k in counters_outside:
            counters_outside[k] -= c_prof[k]
    loop.in_window = False

    # -- the drain: the load stays on until the window's requests end --
    wanted = [r for r in loop.all_reqs if r.window]
    steps = sum(1 for t in loop.step_ends if w0 < t <= w1)
    while any(r.done is None for r in wanted):
        if time.perf_counter() - w1 > DRAIN_LIMIT_S:
            raise RuntimeError("drain: a request of the window never "
                               "finished")
        loop.dispatch()
        loop.step()
        loop.poll()

    memory_peak = (int(torch.cuda.max_memory_allocated(device))
                   if device.type == "cuda" else 0)
    expected = sum(r.call.cached for r in loop.all_reqs
                   if w0 < r.submitted <= w1)
    all_reqs, step_ends = loop.all_reqs, loop.step_ends

    # free the program's state: the engine, its pool and every handle
    for r in loop.all_reqs:
        r.handle = None
    loop.inflight = []
    del eng, loop
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Result(setup_s=setup_s, w0=w0, w1=w1, requests=wanted,
                  all_reqs=all_reqs,
                  counters_window=counters_window, counters_sub=c_sub,
                  sub=tuple(sub) if sub else None,
                  profiled=tuple(profiled) if profiled else None,
                  counters_outside=counters_outside, steps_sub=steps_sub,
                  step_s=step_s, step_ends=step_ends, dtrace=dtrace,
                  trace_tries=tries,
                  memory_peak_bytes=memory_peak, weights=(base, decs),
                  steps=steps, expected_reused=expected)
