"""Synthetic task-domain data pipeline (a copy of
``repro.training.data``: numpy only, batches byte-identical for a seed).

Stands in for the paper's MetaMathQA / EvolInstruct-Code / xLAM domains with
three prompt-dependent tasks a tiny transformer can learn on CPU. Every answer
is a pure function of the PROMPT, so solving the task requires actually
reading the prompt's cache — which is exactly what cache-conditioned
fine-tuning must preserve when the cache comes from a frozen base model.

Domains (our Table-1 analogues):
  math    — cumulative sum mod 10 of a digit sequence ("GSM8K")
  copy    — forward copy of the payload ("HumanEval": exact structured output)
  reverse — reverse copy (harder positional variant, used in --full runs)
  lookup  — key/value recall: answer the value of the queried keys ("BFCL")

Token map: 0=PAD 1=BOS 2=SEP 3=EOS; payload symbols start at 4.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

PAD, BOS, SEP, EOS = 0, 1, 2, 3
SYM0 = 4          # payload symbols: SYM0 .. SYM0+n_symbols-1

DOMAINS = ("math", "copy", "reverse", "lookup", "mix")


@dataclass
class TaskSpec:
    domain: str
    prompt_len: int = 24      # payload tokens in prompt
    n_symbols: int = 10
    vocab: int = 64


def _gen_one(rng: np.random.Generator, spec: TaskSpec):
    n = spec.prompt_len
    s0 = SYM0
    if spec.domain == "mix":
        spec = TaskSpec(domain=str(rng.choice(["math", "copy", "lookup"])),
                        prompt_len=spec.prompt_len, n_symbols=spec.n_symbols,
                        vocab=spec.vocab)
    if spec.domain == "math":
        digits = rng.integers(0, spec.n_symbols, n)
        ans = np.cumsum(digits) % spec.n_symbols
        prompt = digits + s0
        answer = ans + s0
    elif spec.domain == "copy":
        # forward copy: induction-head-learnable in O(100) steps at tiny scale
        payload = rng.integers(0, spec.n_symbols, n)
        prompt = payload + s0
        answer = payload.copy() + s0
    elif spec.domain == "reverse":
        payload = rng.integers(0, spec.n_symbols, n)
        prompt = payload + s0
        answer = payload[::-1] + s0
    elif spec.domain == "lookup":
        k = min(n // 2, spec.n_symbols)
        keys = rng.permutation(spec.n_symbols)[:k]
        vals = rng.integers(0, spec.n_symbols, k)
        pairs = np.stack([keys, vals], 1).reshape(-1)  # k1 v1 k2 v2 ...
        qi = rng.permutation(k)
        prompt = np.concatenate([pairs, keys[qi]]) + s0
        answer = vals[qi] + s0
    else:
        raise ValueError(spec.domain)
    return prompt.astype(np.int32), answer.astype(np.int32)


@dataclass
class Batch:
    prompt: np.ndarray       # (B, Sp) BOS + payload + SEP
    target_in: np.ndarray    # (B, St) teacher-forced decoder input
    target_out: np.ndarray   # (B, St) next-token labels
    target_mask: np.ndarray  # (B, St)


def make_batch(rng: np.random.Generator, spec: TaskSpec, batch: int) -> Batch:
    ps, ans = zip(*[_gen_one(rng, spec) for _ in range(batch)])
    sp = max(len(p) for p in ps) + 2
    st = max(len(a) for a in ans) + 1
    P = np.zeros((batch, sp), np.int32)
    TI = np.zeros((batch, st), np.int32)
    TO = np.zeros((batch, st), np.int32)
    M = np.zeros((batch, st), np.float32)
    for i, (p, a) in enumerate(zip(ps, ans)):
        row = np.concatenate([[BOS], p, [SEP]])
        P[i, -len(row):] = row              # left-pad (keeps SEP adjacent to target)
        ti = np.concatenate([[SEP], a])[: st]
        to = np.concatenate([a, [EOS]])[: st]
        TI[i, : len(ti)] = ti
        TO[i, : len(to)] = to
        M[i, : len(to)] = 1.0
    # NOTE: with uniform prompt_len, all rows have identical lengths; padding
    # logic is exercised by property tests with ragged specs.
    return Batch(P, TI, TO, M)


def batches(seed: int, spec: TaskSpec, batch: int, steps: int) -> Iterator[Batch]:
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield make_batch(rng, spec, batch)


def answer_accuracy(pred_tokens: np.ndarray, target_out: np.ndarray,
                    target_mask: np.ndarray) -> float:
    """Exact-match over masked answer positions (EOS included)."""
    ok = (pred_tokens == target_out) | (target_mask == 0)
    return float(ok.all(axis=-1).mean())
