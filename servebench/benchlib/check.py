"""Whether the timed path served what the model says: the ``correct`` of a
run.

Once the drain has ended and the program's state is freed, a sample of the
requests sent in the window, drawn from the seed, holding the longest of
them and an equal share for every decoder, is scored by the plain
reference (``servebench/reference``, named by the configuration): the
base model's K/V of each prompt and the decoder's logits at each served
position, fed the served tokens. A served token's gap is how far its
reference logit lies below the reference's best at that position; the
cell compares ``max_gap``, the widest gap over the sample, with its limit,
and needs its least number of served tokens checked. Besides, every
request sent in the window has to be served in full: greedy with no stop
token, each answers exactly its ``gen`` tokens, so a request that failed
or ended early counts against ``correct`` (``not_served_in_full``, limit
0), wherever it stands in the sample.

The control (``control=True``, used to set the limit, never in a
benchmark run) scores the same positions with the reference computed in
float8 e4m3 (W8A8 with per-tensor scales and a float8 K/V cache): at each
position the token the lower precision puts first, and its gap in the
float32 reference.
"""
from __future__ import annotations

import torch

from benchlib.traffic import rng


def sample(reqs: list, k: int, n_models: int, seed: int) -> list:
    """The longest finished request (prompt plus served tokens) and others
    drawn from the seed, ``k // n_models`` for each decoder in all."""
    pool = [r for r in reqs if r.done is not None and not r.failed
            and r.tokens]
    if not pool:
        return []
    pool.sort(key=lambda r: (len(r.call.prompt) + len(r.tokens),
                             r.submitted))
    longest = pool.pop()
    picked = [longest]
    g = rng(seed, 11)
    for m in range(n_models):
        mine = [r for r in pool if r.call.model == m]
        want = max(0, k // n_models - (longest.call.model == m))
        idx = g.choice(len(mine), size=min(want, len(mine)), replace=False)
        picked += [mine[i] for i in sorted(idx)]
    return picked


def _items(reqs: list, first_token: int) -> list:
    return [{"tokens": list(r.call.prompt),
             "fed": [first_token] + list(r.tokens[:-1]),
             "served": list(r.tokens),
             "model": r.call.model} for r in reqs]


def _gaps(logits, tokens) -> torch.Tensor:
    t = torch.as_tensor(tokens, device=logits.device)
    return logits.max(-1).values - logits.gather(1, t[:, None])[:, 0]


def score(ref, hp, weights, reqs, first_token, *,
          control: bool = False) -> dict:
    """``{"gaps": [per item widest gap], "max_gap", "tokens",
    "argmax_match", "control_gap"?}`` for the sampled requests."""
    base, decs = weights
    items = _items(reqs, first_token)
    logits = ref.served_logits(hp, base, decs, items)
    gaps = [_gaps(lg, it["served"]) for lg, it in zip(logits, items)]
    tokens = sum(len(it["served"]) for it in items)
    out = {"gaps": [float(g.max()) for g in gaps],
           "max_gap": max(float(g.max()) for g in gaps),
           "tokens": tokens,
           "argmax_match": sum(int((g == 0).sum()) for g in gaps) / tokens}
    if control:
        low = ref.served_logits(hp, base, decs, items, fp8=True)
        cg = [_gaps(lg, lo.argmax(-1).tolist())
              for lg, lo in zip(logits, low)]
        out["control_gaps"] = [float(g.max()) for g in cg]
        out["control_gap"] = max(out["control_gaps"])
    return out


def not_served_in_full(reqs: list) -> int:
    """How many of ``reqs`` failed or answered other than ``gen`` tokens."""
    return sum(1 for r in reqs
               if r.failed or len(r.tokens) != r.call.gen)


def verdict(scored: dict | None, limits: dict,
            reqs: list) -> tuple[bool, dict]:
    """``(correct, checks)``: the window's requests ``reqs`` not served in
    full beside 0, the widest gap beside its limit, and the served tokens
    checked beside their least count."""
    short = not_served_in_full(reqs)
    checks = {"not_served_in_full": {"value": short, "limit": 0},
              "max_gap": {"value": None if scored is None
                          else scored["max_gap"],
                          "limit": limits["max_gap"]},
              "tokens_checked": {"value": 0 if scored is None
                                 else scored["tokens"],
                                 "min": limits["min_tokens"]}}
    ok = (short == 0 and scored is not None
          and scored["tokens"] >= limits["min_tokens"]
          and scored["max_gap"] <= limits["max_gap"])
    return ok, checks


def control_verdict(scored: dict | None, limits: dict,
                    reqs: list) -> tuple[bool, dict]:
    """``verdict`` of the control: its numbers in the program's place, at
    the same positions. A control that gave no number has failed."""
    if scored is None or "control_gap" not in scored:
        return False, {}
    return verdict({"max_gap": scored["control_gap"],
                    "tokens": scored["tokens"]}, limits, reqs)
