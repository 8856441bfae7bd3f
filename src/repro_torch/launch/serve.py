"""Serving launcher: prompt fed through the decode step, then greedy
generation with KV caches; latency percentiles by the paper's selection
primitive on the card.  The port of ``repro.launch.serve``:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b --gen 16

The loop lives in :func:`serve`, which ``main()`` calls with the reduced
config, as the reference does; a caller can hand it any config and
weights (``chip_smoke.py`` serves the full-width phi3-mini through it).
"""
from __future__ import annotations

import argparse
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch import _device
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, local_plan
from repro_torch.core import selection
from repro_torch.models import model
from repro_torch.train import make_serve_step


class Served(NamedTuple):
    tokens: torch.Tensor      # (B, P + G - 1) int32, each step's argmax
    latencies: torch.Tensor   # (P + G - 3,) f32 s, the steps after two
    p50: selection.SelectResult
    p99: selection.SelectResult


def latency_percentiles(lat):
    """Median and 0.99-quantile of per-step latencies (a 1-D tensor) by
    exact selection, on the tensor's device."""
    return selection.median(lat), selection.quantile(lat, 0.99)


def serve(cfg: ModelConfig, batch: int = 4, prompt_len: int = 16,
          gen: int = 16, *, params=None, device=None) -> Served:
    """Feed a random prompt of ``prompt_len`` tokens (numpy seed 0, as the
    reference's) through the serve step, then generate ``gen`` tokens
    greedily; time each step (host clock around a synchronized step).
    ``params`` defaults to an f32 decoder drawn from seed 0; the cache is
    f32, as the reference's."""
    device = _device.resolve(device, "serve")
    plan = local_plan()
    B, P, G = batch, prompt_len, gen
    rng = np.random.default_rng(0)
    if params is None:
        params = model.init(0, cfg, device=device)

    step = make_serve_step(cfg, plan)
    cache = model.init_cache(cfg, B, max_seq=P + G, plan=plan,
                             dtype=torch.float32, device=device)
    prompt = torch.from_numpy(
        rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)).to(device)

    tok = prompt[:, :1]
    lat, out = [], []
    for t in range(P + G - 1):
        nxt = prompt[:, t + 1:t + 2] if t + 1 < P else None
        t0 = time.perf_counter()
        tok_out, _, cache = step(params, cache, tok, t)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        lat.append(time.perf_counter() - t0)
        out.append(tok_out)
        tok = nxt if nxt is not None else tok_out

    ts = torch.tensor(lat[2:], dtype=torch.float32, device=device)
    return Served(torch.cat(out, dim=1), ts, *latency_percentiles(ts))


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="phi3-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' by name)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    res = serve(cfg, args.batch, args.prompt_len, args.gen,
                device=args.device)
    B, P, G = args.batch, args.prompt_len, args.gen
    print(f"arch={cfg.name} (reduced) B={B}: served {P + G} positions")
    print(f"latency p50={float(res.p50.value)*1e3:.2f}ms "
          f"p99={float(res.p99.value)*1e3:.2f}ms")


if __name__ == "__main__":
    main()
