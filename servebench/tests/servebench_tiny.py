"""Helpers of the harness's CPU tests: a checkout-like root whose cells
are cut to a size the CPU runs in seconds, and a run of one of them.

The root holds ``BENCHMARK.json`` and a copy of ``servebench/`` with every
configuration at 2 layers of width 64, the traffic's prompts and answers a
few tens of tokens, and 4 clients. The harness's code is imported from the
real ``servebench/``.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (REPO / "servebench", REPO / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

SEED = 2 ** 31 + 7
CELLS = ["react-agents4.internlm2-1.8b",
         "react-agents4-unshared.internlm2-1.8b"]
#: the tiny sizes of each traffic mix's keys
TINY_MIX = {"system_tokens": 24, "delta_tokens": 12, "gen_tokens": 6}


def tiny_root(dst: Path, *, dtype: str = "float32", max_gap: float = 1e-4,
              clients: int = 4) -> Path:
    shutil.copytree(REPO / "servebench", dst / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    for f in (dst / "servebench/configs").glob("*.json"):
        c = json.loads(f.read_text())
        c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
                 num_key_value_heads=2, head_dim=16, intermediate_size=128,
                 vocab_size=512, torch_dtype=dtype)
        c["engine"].update(num_pages=400, chunk_size=16, token_budget=48)
        f.write_text(json.dumps(c))
    for f in (dst / "servebench/traffic").glob("*.json"):
        t = json.loads(f.read_text())
        t.update({k: v for k, v in TINY_MIX.items() if k in t})
        f.write_text(json.dumps(t))
    for f in (dst / "servebench/cells").glob("*.json"):
        c = json.loads(f.read_text())
        c["clients"] = clients
        c["check"].update(min_tokens=8, max_gap=max_gap)
        f.write_text(json.dumps(c))
    return dst


def run(root: Path, cell_name: str, *, seconds: float = 2.0,
        trace: bool = False, control: bool = False, seed: int = SEED):
    import torch
    from benchlib import harness, spec
    torch.set_num_threads(1)          # as ``run.py`` runs the harness
    cell = spec.load_cell(root, cell_name)
    return harness.run_cell(root, cell, seed=seed, seconds=seconds,
                            trace=trace, device=torch.device("cpu"),
                            t_start=time.perf_counter(), control=control)
