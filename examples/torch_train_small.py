"""End-to-end training example on the PyTorch port: train a small LM with
the full substrate (AdamW, cosine schedule, gradient accumulation,
atomic checkpoints, optional int8 error-feedback gradient compression).
Crash-safe: running the same command again resumes from the latest
checkpoint. The port's counterpart of `examples/train_small.py`, with
the same presets; it runs on the card unless `--device cpu` is given.

    PYTHONPATH=src python examples/torch_train_small.py --device cpu
    PYTHONPATH=src python examples/torch_train_small.py --preset 100m --steps 300
"""
import argparse

from repro_torch.configs import ARCHS, smoke_variant
from repro_torch.models import Model
from repro_torch.training.data import TokenStream
from repro_torch.training.train_loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=("tiny", "100m"), default="tiny")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--ckpt", default="runs/torch_train_small")
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    if args.preset == "tiny":
        cfg = smoke_variant(ARCHS["granite-3-2b"]).replace(vocab=512)
        batch, seq = 8, 64
    else:  # ~100M-param granite-family config
        cfg = ARCHS["granite-3-2b"].replace(
            n_layers=10, d_model=640, n_heads=10, n_kv_heads=5,
            head_dim=64, d_ff=2560, vocab=32000, remat=True)
        batch, seq = 16, 512
    model = Model(cfg, device=args.device)
    n = sum(p.numel() for p in model.parameters())
    print(f"arch={cfg.name} params={n / 1e6:.1f}M batch={batch} seq={seq} "
          f"device={model.device}")
    data = TokenStream(cfg.vocab, seq, batch, seed=0)
    out = train(model, data,
                TrainConfig(n_steps=args.steps, ckpt_every=50,
                            ckpt_dir=args.ckpt,
                            grad_compression=args.compress_grads))
    print(f"loss {out['first_loss']:.3f} -> {out['final_loss']:.3f}")
    return out


if __name__ == "__main__":
    main()
