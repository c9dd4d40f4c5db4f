"""The traffic generator: the same seed gives the same prompts, every seed
the same sizes, and each call's cached prefix is what the earlier calls
committed, for each committed mix."""
from __future__ import annotations

import json

import pytest

import servebench_tiny as tiny
from benchlib import traffic as T

PAGE = 16


def _mix(name: str) -> dict:
    return json.loads((tiny.REPO / "servebench/traffic" / f"{name}.json")
                      .read_text())


def _traffic(name: str, seed: int = tiny.SEED, clients: int = 64,
             n_models: int = 4) -> T.Traffic:
    return T.Traffic(_mix(name), clients=clients, vocab=92544,
                     n_models=n_models, seed=seed, page_size=PAGE)


def _session_calls(t: T.Traffic, thread) -> list:
    """Every call of one session in order, each answered with its full
    length of stand-in tokens."""
    calls = []
    for i in range(thread.n_calls):
        c = thread.call(i)
        calls.append(c)
        thread.on_finish(i, list(range(c.gen)), c.gen)
    return calls


@pytest.mark.parametrize("mix", ["react-agents4", "react-agents4-unshared"])
def test_same_seed_same_prompts(mix):
    def draw(seed):
        t = _traffic(mix, seed)
        prefill, first = t.start()
        out = [tuple(ctx) for _, ctx in prefill]
        for thread, i, n in first:
            c = thread.call(i)
            out.append((tuple(c.prompt), c.model, c.gen, n))
        return out
    assert draw(12345678901) == draw(12345678901)
    assert draw(12345678901) != draw(12345678902)


def test_react_session_is_the_papers_workflow():
    """System 512, then 12 calls, agent i mod 4 on decoder i mod 4; call
    i's prompt is the context so far plus its 160-token delta, and reuses
    every whole page of the previous call's prompt."""
    t = _traffic("react-agents4")
    calls = _session_calls(t, t.open())
    assert [c.model for c in calls] == [0, 1, 2, 3] * 3
    assert [c.gen for c in calls] == [128] * 12
    lengths = [len(c.prompt) for c in calls]
    assert lengths == [512 + 160 * (i + 1) + 128 * i for i in range(12)]
    assert calls[0].cached == 0
    for prev, c in zip(calls, calls[1:]):
        assert c.prompt[:len(prev.prompt)] == prev.prompt
        assert c.cached == len(prev.prompt) // PAGE * PAGE
    assert calls[-1].prompt[-160:] != calls[-2].prompt[-160:]


def test_unshared_control_has_the_same_lengths_and_shares_nothing():
    shared = _session_calls(*(lambda t: (t, t.open()))(
        _traffic("react-agents4")))
    t = _traffic("react-agents4-unshared")
    fresh = _session_calls(t, t.open())
    assert [len(c.prompt) for c in fresh] == [len(c.prompt) for c in shared]
    assert [(c.model, c.gen) for c in fresh] == \
        [(c.model, c.gen) for c in shared]
    assert all(c.cached == 0 for c in fresh)
    seen = set()
    for c in fresh:                     # no prompt starts with an earlier
        first_page = tuple(c.prompt[:PAGE])
        assert first_page not in seen
        seen.add(first_page)


def test_only_set_up_answers_are_padded():
    """A cut answer of set-up joins the context padded to the call's
    length; an answer of the window joins it as served, so one that ended
    early leaves the next prompt short (and ``check`` calls the run not
    correct)."""
    lengths = []
    for pad in (128, 0):
        t = _traffic("react-agents4")
        s = t.open()
        c = s.call(0)
        s.on_finish(0, [7] * 5, pad)
        lengths.append(len(s.call(1).prompt) - len(c.prompt))
    assert lengths == [128 + 160, 5 + 160]


def test_an_unknown_kind_is_refused():
    with pytest.raises(KeyError):
        T.Traffic({"kind": "documents", "gen_tokens": 8}, clients=1,
                  vocab=100, n_models=1, seed=1, page_size=PAGE)


@pytest.mark.parametrize("mix", ["react-agents4", "react-agents4-unshared"])
def test_start_spreads_clients(mix):
    """Every client has one first call; the cut answers spread evenly over
    [1, the answer length] and the sessions over their 12 calls; only the
    shared mix prefills histories."""
    t = _traffic(mix)
    prefill, first = t.start()
    assert len(first) == 64
    cuts = sorted(n for _, _, n in first)
    assert cuts == [i * 128 // 64 + 1 for i in range(64)]
    offsets = sorted(i for _, i, _ in first)
    assert offsets == [i * 12 // 64 for i in range(64)]
    if mix == "react-agents4":
        assert len(prefill) == sum(1 for o in offsets if o)
    else:
        assert prefill == []
