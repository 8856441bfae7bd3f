"""Training launcher, the port of ``repro.launch.train``: real optimizer
steps with a reduced config on one device — data pipeline -> train step
(AdamW, the quantile clip) -> checkpoints -> step-time telemetry.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma2-2b --steps 50

Runs on the GPU; ``--device cpu`` asks for the CPU by name.  The
reference's ``--aot`` compiles the production config through XLA's dry-run
machinery, which has no torch counterpart (ROADMAP Queue 1 item 11h): the
flag raises (and ``--shape`` / ``--multi-pod``, which only ``--aot``
reads, are not taken).  The loop lives in :func:`train`, which ``main()`` calls with
the reduced config; a caller can hand it any config.
"""
from __future__ import annotations

import argparse
from typing import Callable, Optional

from repro_torch import _device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ARCH_IDS, ModelConfig, get_config, local_plan
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import SyntheticPipeline
from repro_torch.models import model
from repro_torch.optim import AdamW
from repro_torch.train import TrainState, fit, make_train_step

AOT = ("--aot lowers and compiles the production config through XLA's "
       "dry-run machinery (repro.launch.dryrun), which has no torch "
       "counterpart (ROADMAP Queue 1 item 11h)")


def train(cfg: ModelConfig, *, steps: int, batch: int, seq: int,
          clip: str = "quantile", ckpt_dir: str = "", ckpt_every: int = 25,
          log_every: int = 10, lr: float = 3e-4, seed: int = 0,
          device=None, log_fn: Callable[[str], None] = print):
    """Train ``cfg`` from weights drawn from ``seed`` (or from the latest
    checkpoint in ``ckpt_dir``) to step ``steps`` with AdamW; returns
    ``fit``'s record."""
    device = _device.resolve(device, "train")
    plan = local_plan()
    shape = ShapeConfig("cli", seq_len=seq, global_batch=batch, kind="train")
    params = model.init(seed, cfg, device=device)
    opt = AdamW(lr=lr)
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step_fn = make_train_step(cfg, plan, opt, clip=clip)
    ckpt = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir else None
    # at step 0: on a restore, fit moves the pipeline to the restored step
    pipe = SyntheticPipeline(cfg, shape, seed=seed)
    try:
        return fit(train_step=step_fn, state=state, pipeline=pipe,
                   steps=steps, ckpt=ckpt, ckpt_every=ckpt_every,
                   log_every=log_every, log_fn=log_fn)
    finally:
        pipe.close()


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--clip", default="quantile",
                    choices=("quantile", "global_norm", "none"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--aot", action="store_true",
                    help="not available: " + AOT)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' by name)")
    args = ap.parse_args(argv)
    if args.aot:
        raise NotImplementedError(AOT)

    cfg = get_config(args.arch).reduced()
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                clip=args.clip, ckpt_dir=args.ckpt_dir, device=args.device)
    print(f"done: loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}")


if __name__ == "__main__":
    main()
