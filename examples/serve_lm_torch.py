"""Serving example on the PyTorch port: greedy decode with KV caches, with
latency percentiles computed by the paper's selection primitive (no sort)
on the card.  The port's counterpart of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/serve_lm_torch.py --batch 4 --prompt-len 32 --gen 24

Runs on the GPU; ``--device cpu`` asks for the CPU by name.
"""
import argparse

from repro_torch.configs import get_config
from repro_torch.launch.serve import serve


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' by name)")
    args = ap.parse_args()

    cfg = get_config(args.arch).reduced()
    P, G = args.prompt_len, args.gen
    # the prompt goes through the decode step token by token, then G
    # tokens are generated: P + G timed steps, the first two dropped
    res = serve(cfg, args.batch, P, G + 1, device=args.device)
    gen = res.tokens[:, P:].cpu().numpy()
    p50 = float(res.p50.value) * 1e3
    p99 = float(res.p99.value) * 1e3
    print(f"arch={cfg.name} (reduced): generated {gen.shape} tokens")
    print(f"first sequence: {gen[0][:12]} ...")
    print(f"per-token latency: p50={p50:.2f}ms p99={p99:.2f}ms "
          f"(percentiles via cutting-plane selection)")


if __name__ == "__main__":
    main()
