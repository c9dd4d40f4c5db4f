"""The one traffic generator: sessions of calls that closed-loop clients run.

A traffic mix is a JSON file of parameters (``servebench/traffic/*.json``)
whose ``kind`` picks the session's shape. One kind stands today:

``"agents"``: a multi-agent session (the paper's ReAct workflow). It has
  ``system_tokens`` of its own, then ``turns`` x ``agents`` calls in order;
  call i is made by agent ``i mod agents``, served by decoder
  ``agent mod n_models``. Before each call ``delta_tokens`` are appended to
  the session's context and the call's prompt is that context; its
  ``gen_tokens`` greedy tokens join the context, so call i+1 is sent when
  call i has finished. With ``"fresh": true`` every prompt is instead new
  tokens of the same length (nothing shared with any earlier prompt): the
  control that leaves the prefix cache nothing to do.

Sizes are whole numbers of tokens, the same for every seed. Token ids are
drawn uniformly from [``FIRST_ID``, vocab) by the seed.

Clients are closed loops: a free client takes the call that became
available first; when none is, it opens a new session. ``start`` lays out
the sessions at the window's edge: sessions spread over their calls (a seed
permutation of an even spread), their earlier contexts to be prefilled in
set-up, and each client's first call cut to a share of its answer (again a
permutation of an even spread), so the in-flight requests stand at every
decode position when the loop reaches steady state.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FIRST_ID = 4                   # ids below are left to special tokens
SID0 = 1 << 20                 # engine session ids of the sessions


def rng(seed: int, *key) -> np.random.Generator:
    """A generator for draw ``key`` of run ``seed`` (any whole number)."""
    return np.random.default_rng([int(seed) % (1 << 63), *key])


def spread(n: int, top: int, seed: int, key: int) -> list:
    """``n`` whole numbers spread evenly over [0, top), in a seed order."""
    vals = [(i * top) // n for i in range(n)]
    return [vals[i] for i in rng(seed, 6, key).permutation(n)]


@dataclass
class Call:
    """One request: its prompt, its decoder, how many tokens it decodes;
    ``cached``: the prompt tokens the prefix cache should serve (whole
    pages of what earlier calls committed)."""
    session: "Session"
    index: int
    prompt: list
    model: int
    gen: int
    cached: int


class Session:
    """One multi-agent session: its calls in order, each sent when the
    one before it has finished."""

    def __init__(self, traffic: "Traffic", serial: int):
        self.traffic, self.serial = traffic, serial
        self.sid = SID0 + serial
        self.finished = 0
        self.fresh = bool(traffic.mix.get("fresh"))
        m = traffic.mix
        self.n_calls = int(m["turns"]) * int(m["agents"])
        self.context = self.ids(int(m["system_tokens"]), 0)
        self.committed = 0          # context tokens earlier prompts hold
        self.next = 0

    def ids(self, n: int, *key) -> list:
        return self.traffic.ids(n, self.serial, *key)

    @property
    def done(self) -> bool:
        return self.finished >= self.n_calls

    def call(self, i: int) -> Call:
        t = self.traffic
        self.context += self.ids(t.delta, 1, i)
        model = (i % int(t.mix["agents"])) % t.n_models
        if self.fresh:
            return Call(self, i, self.ids(len(self.context), 2, i), model,
                        t.gen, 0)
        page = t.page_size
        cached = (min(self.committed, len(self.context)) // page) * page
        self.committed = len(self.context)
        return Call(self, i, list(self.context), model, t.gen, cached)

    def on_finish(self, i: int, answer: list, pad_to: int = 0) -> list:
        """The answer joins the context, padded to ``pad_to`` tokens with
        stand-in tokens (set-up's skipped and cut calls only); the next
        call is due."""
        self.context += list(answer) + self.ids(
            max(0, pad_to - len(answer)), 3, i)
        self.finished += 1
        return [i + 1] if i + 1 < self.n_calls else []

    def history(self, k: int) -> list:
        """Skip the first ``k`` calls: their deltas and stand-in answers
        join the context, which set-up prefills (returned; empty for a
        fresh mix, which reuses nothing)."""
        for i in range(k):
            self.on_finish(i, [], self.call(i).gen)
        self.next = k
        if self.fresh or not k:
            return []
        self.committed = len(self.context)
        return list(self.context)


KINDS = {"agents": Session}


class Traffic:
    """The mix of one cell: ``clients`` closed loops over ``vocab`` ids and
    ``n_models`` decoders, every draw set by ``seed``."""

    def __init__(self, mix: dict, *, clients: int, vocab: int,
                 n_models: int, seed: int, page_size: int):
        self.mix, self.clients, self.vocab = mix, clients, vocab
        self.n_models, self.seed, self.page_size = n_models, seed, page_size
        self.kind = KINDS[mix["kind"]]
        self.gen = int(mix["gen_tokens"])
        self.delta = int(mix.get("delta_tokens", 0))
        self.sessions = 0

    def ids(self, n: int, *key) -> list:
        """``n`` token ids for draw ``key``."""
        if n <= 0:
            return []
        return rng(self.seed, 7, *key).integers(FIRST_ID, self.vocab,
                                                n).tolist()

    def open(self) -> Session:
        t = self.kind(self, self.sessions)
        self.sessions += 1
        return t

    def start(self):
        """The layout at set-up: ``(prefill, first)``. ``prefill``:
        ``[(session, tokens)]``, contexts set-up prefills; ``first``: one
        ``(session, call index, tokens to decode)`` per client, the
        sessions spread over their calls and the answers cut to an even
        spread over [1, the answer's length]."""
        cut = [g + 1 for g in spread(self.clients, self.gen, self.seed, 1)]
        n_calls = int(self.mix["turns"]) * int(self.mix["agents"])
        offsets = spread(self.clients, n_calls, self.seed, 2)
        prefill, first = [], []
        for c in range(self.clients):
            t = self.open()
            ctx = t.history(offsets[c])
            if ctx:
                prefill.append((t, ctx))
            first.append((t, offsets[c], cut[c]))
        return prefill, first
