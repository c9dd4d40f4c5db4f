"""Serving launcher: run the disaggregated simulator (one H100's cost
terms) or the local engine, from the CLI.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31-8b \\
        --pattern react --rate 4 --mode prefillshare
    PYTHONPATH=src python -m repro_torch.launch.serve --engine local --gen 8 \\
        [--device cpu]

Port of ``repro.launch.serve`` with its flags, plus ``--device`` for
``--engine local`` (default: the card; there is no fallback to the CPU).
``--chips`` prices each simulated worker at that many H100s of 80 GB.
The local engine serves the reference's toy fp32 dense config with seeded
random weights (``models.init_params`` on the CPU, moved to the device:
seed 0 for the base, 3 + i for agent i), not the reference's
``jax.random`` numbers; ``run_engine``'s ``build_weights`` takes other
weights.
"""
from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.serving.costmodel import HBM_BYTES
from repro_torch.serving.simulator import ServingConfig, Simulator
from repro_torch.serving.workload import make_sessions

#: the reference launcher's toy engine config
TOY = ModelConfig(name="local", arch_type="dense", n_layers=3, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                  dtype="float32")


def run_sim(args):
    cfg = get_config(args.arch)
    sessions = make_sessions(args.pattern, n_sessions=args.sessions,
                             arrival_rate=args.rate, seed=args.seed)
    scfg = ServingConfig(mode=args.mode, max_concurrent=args.max_concurrent,
                         chips_per_worker=args.chips,
                         hbm_per_worker=args.chips * HBM_BYTES)
    sim = Simulator(cfg, scfg, sessions)
    print(json.dumps(sim.run(), indent=1))


def toy_weights(cfg: ModelConfig, agents: int, device):
    """``(base, {agent_id: params})``: seeded random weights drawn on the
    CPU, whose generator gives the same numbers whatever ``device`` they
    are then moved to (a CUDA generator draws others)."""
    from repro_torch.models import init_params
    from repro_torch.params import tree_map

    def weights(seed):
        return tree_map(lambda x: x.to(device), init_params(cfg, seed, "cpu"))
    return weights(0), {f"agent{i}": weights(3 + i) for i in range(agents)}


def run_engine(args, build_weights=toy_weights):
    import numpy as np

    from repro_torch.device import resolve_device
    from repro_torch.serving.api import SamplingParams
    from repro_torch.serving.engine import LocalDisaggEngine

    device = resolve_device(args.device)
    cfg = TOY
    base, decs = build_weights(cfg, args.agents, device)
    eng = LocalDisaggEngine(cfg, base, device=device, capacity=512)
    for mid, p in decs.items():
        eng.models.register(mid, p)
    rng = np.random.default_rng(0)
    ctx = list(rng.integers(4, 60, size=32))
    for turn in range(args.turns):
        for a in decs:
            ctx += list(rng.integers(4, 60, size=8))
            out = eng.generate(a, ctx, SamplingParams(max_tokens=args.gen),
                               session=0).result()
            ctx += list(out)
            print(f"turn {turn} {a}: ctx={len(ctx)} gen={out.tolist()}")
    s = eng.stats
    print(f"hit_ratio={s.hit_ratio:.3f} handoff_mb={s.handoff_bytes / 1e6:.2f}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", choices=["sim", "local"], default="sim")
    ap.add_argument("--arch", default="llama31-8b")
    ap.add_argument("--pattern", default="react")
    ap.add_argument("--mode", default="prefillshare",
                    choices=["baseline", "prefillshare"])
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--sessions", type=int, default=80)
    ap.add_argument("--max-concurrent", type=int, default=64)
    ap.add_argument("--chips", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--gen", type=int, default=6)
    ap.add_argument("--device", default=None,
                    help="torch device of --engine local (default: the card)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    (run_engine if args.engine == "local" else run_sim)(args)


if __name__ == "__main__":
    main()
