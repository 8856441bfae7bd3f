"""End-to-end training on the PyTorch port: trains a small LM with the
full stack — data pipeline, AdamW, quantile gradient clipping (the paper's
primitive), checkpointing, restart, and step-time percentiles by exact
selection on the card.  The port's counterpart of ``examples/train_lm.py``.

  PYTHONPATH=src python examples/train_lm_torch.py --steps 200          # ~10M params
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --large  # ~100M params

Resume after interruption: run it again with the same ``--ckpt-dir``.
Runs on the GPU; ``--device cpu`` asks for the CPU by name.
"""
import argparse

from repro_torch.analysis import param_counts
from repro_torch.configs import get_config
from repro_torch.launch.train import train
from repro_torch.models import model


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--large", action="store_true",
                    help="~100M-param config")
    ap.add_argument("--ckpt-dir", default="build/lm_ckpt_torch")
    ap.add_argument("--clip", default="quantile",
                    choices=("quantile", "global_norm", "none"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' by name)")
    args = ap.parse_args()

    base = get_config(args.arch)
    if args.large:
        cfg = base.reduced(d_model=512, n_heads=8, head_dim=64,
                           n_kv_heads=min(base.n_kv_heads, 4), d_ff=2048,
                           vocab=32768,
                           n_layers=len(base.layer_pattern) * 4)
    else:
        cfg = base.reduced(d_model=256, n_heads=4, head_dim=64, d_ff=1024,
                           vocab=8192,
                           n_layers=len(base.layer_pattern) * 2)
    n_params = param_counts(model.init(0, cfg, device="meta"), cfg)[0]
    print(f"arch={cfg.name} (reduced) params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq} clip={args.clip}")

    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                clip=args.clip, ckpt_dir=args.ckpt_dir, ckpt_every=50,
                device=args.device)
    print(f"final loss: {out['losses'][-1]:.4f} "
          f"(first: {out['losses'][0]:.4f}); retries={out['retries']}")


if __name__ == "__main__":
    main()
