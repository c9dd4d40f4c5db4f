"""Training launcher: pretrain a base, fine-tune one decoder
cache-conditioned (Eq. 7), evaluate it on the base's shared cache, and
write both checkpoints in the reference's format.

    PYTHONPATH=src python -m repro_torch.launch.train --arch internlm2-1.8b \\
        --reduced --domain copy --pretrain-steps 300 --steps 300 \\
        --out build/ckpt [--device cpu]

Port of ``repro.launch.train`` with its flags, plus ``--device`` (default:
the card; there is no fallback to the CPU). The weights are seeded random
(``models.init_params``), not the reference's ``jax.random`` numbers.
Checkpoints are ``{out}_base`` and ``{out}_{domain}`` (``.npz`` +
``.json``), readable by ``repro.training.checkpoint.load``.
"""
from __future__ import annotations

import argparse
import functools
import time

from repro_torch.configs.base import get_config
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.model import train_loss
from repro_torch.training import data as D
from repro_torch.training.checkpoint import save
from repro_torch.training.optim import AdamW, warmup_cosine
from repro_torch.training.trainer import (Trainer, evaluate,
                                          finetune_cache_conditioned,
                                          pretrain_batches)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-trainable)")
    ap.add_argument("--domain", default="copy", choices=list(D.DOMAINS))
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1.5e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/ckpt")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    return ap


def run(args) -> dict:
    """The launcher's path for parsed ``args``. Returns the config, both
    trees, each phase's losses, the shared-cache accuracy and the
    checkpoint stems."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(vocab=64)
    device = resolve_device(args.device)
    spec = D.TaskSpec(domain=args.domain, n_symbols=8, prompt_len=10,
                      vocab=cfg.vocab_size)
    print(f"[train] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"params~{cfg.param_count() / 1e6:.1f}M domain={args.domain} "
          f"on {device}")

    t0 = time.time()
    base = init_params(cfg, args.seed, device)
    tr = Trainer(functools.partial(train_loss, cfg, remat=False),
                 AdamW(warmup_cosine(2e-3, args.pretrain_steps),
                       weight_decay=0.01))
    base, pre_losses = tr.fit(base, pretrain_batches(
        cfg, args.seed, args.pretrain_steps, args.batch,
        spec=D.TaskSpec(domain="mix", n_symbols=8, prompt_len=10,
                        vocab=cfg.vocab_size)),
        log_every=100, tag="pretrain-base")
    base_path = f"{args.out}_base"
    save(base_path, base, meta={"arch": cfg.name, "role": "base"})

    dec, ft_losses = finetune_cache_conditioned(
        cfg, base, base, args.domain, seed=args.seed + 1, steps=args.steps,
        batch=args.batch, lr=args.lr, spec=spec, log_every=100)
    dec_path = f"{args.out}_{args.domain}"
    save(dec_path, dec, meta={"arch": cfg.name,
                              "role": f"decoder/{args.domain}"})

    acc = evaluate(cfg, dec, base, args.domain, seed=99, share_ratio=1.0,
                   spec=spec, per_token=True)
    print(f"[train] done in {time.time() - t0:.0f}s; shared-cache accuracy "
          f"{acc:.3f}; checkpoints at {args.out}_*")
    return dict(cfg=cfg, base=base, dec=dec, pretrain_losses=pre_losses,
                losses=ft_losses, acc=acc, base_path=base_path,
                dec_path=dec_path)


def main(argv=None) -> None:
    run(parser().parse_args(argv))


if __name__ == "__main__":
    main()
