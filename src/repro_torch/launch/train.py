"""Training launcher CLI: any zoo arch, full width on the card or the
smoke variant (CPU-sized).

Port of `repro.launch.train`, every flag kept, plus `--device` (the card
unless ``cpu`` is asked for; without a card and without ``--device cpu``
it raises, as every entry point of the port does).

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \\
        --smoke --steps 60 --ckpt runs/ckpt_demo --device cpu
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_variant
    from ..models import Model
    from ..training.data import TokenStream
    from ..training.train_loop import TrainConfig, train

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg)
    model = Model(cfg, device=args.device)
    n = sum(p.numel() for p in model.parameters())
    print(f"{cfg.name}: {n / 1e6:.1f}M params on {model.device}")
    data = TokenStream(cfg.vocab, args.seq, args.batch, seed=0)
    out = train(model, data, TrainConfig(
        n_steps=args.steps, ckpt_dir=args.ckpt or None,
        grad_compression=args.compress_grads,
        microbatches=args.microbatches))
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
