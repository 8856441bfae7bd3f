"""Fault-tolerant training loop, ported from ``repro.train.loop``.

* checkpoint/restart: resumes from the latest complete checkpoint; the data
  pipeline is a pure function of (seed, step), so the resumed run sees the
  batches the uninterrupted one would have;
* step-retry: a failed or non-finite step restores the last checkpoint and
  replays from there (the pipeline moved back to the restored step);
* step-time telemetry: p50/p99 of the last 100 step times by the paper's
  own selection primitive (no sort), on the decoder's device, every
  ``log_every`` steps.

No ``jax.jit``: the step runs eagerly, and the host clock is read around
it with the device synchronized.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import selection
from repro_torch.data import SyntheticPipeline
from repro_torch.train.step import TrainState


def step_time_percentiles(times, device):
    """(p50, p99) of a list of step times (seconds) as ``SelectResult``s,
    by exact selection on ``device``."""
    ts = torch.tensor(times, dtype=torch.float32, device=device)
    return selection.median(ts), selection.quantile(ts, 0.99)


def fit(
    *,
    train_step: Callable,
    state: TrainState,
    pipeline: SyntheticPipeline,
    steps: int,
    ckpt: Optional[CheckpointManager] = None,
    ckpt_every: int = 50,
    log_every: int = 10,
    max_retries: int = 2,
    log_fn: Callable[[str], None] = print,
) -> Dict[str, Any]:
    """Run optimizer steps up to step ``steps`` with checkpoint/restart.

    Returns ``losses``, ``metrics`` (each a dict of floats) and ``times``
    (seconds) of the steps run, ``percentiles`` (each log's step, p50 and
    p99 in seconds, and the cutting-plane passes the two took), the final
    ``state`` and the number of ``retries``."""
    device = state.params.final_norm.device
    cuda = device.type == "cuda"

    start = state.step
    if ckpt is not None and ckpt.latest_step() is not None:
        s = ckpt.latest_step()
        state, manifest = ckpt.restore(s, state)
        start = manifest["step"]
        log_fn(f"[loop] restored checkpoint step={start}")
    if pipeline.step != start:
        pipeline.seek(start)

    times, losses, records, percentiles = [], [], [], []
    retries = 0
    i = start
    while i < steps:
        batch = next(pipeline)
        t0 = time.perf_counter()
        try:
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            if cuda:
                torch.cuda.synchronize(device)
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {i}")
        except Exception as e:  # node-failure analogue: restore + replay
            retries += 1
            if ckpt is None or retries > max_retries:
                raise
            ckpt.wait()  # a save in flight is the latest checkpoint
            s = ckpt.latest_step()
            if s is None:
                raise
            log_fn(f"[loop] step {i} failed ({e}); restoring step {s}")
            state, manifest = ckpt.restore(s, state)
            i = manifest["step"]
            pipeline.seek(i)
            continue

        dt = time.perf_counter() - t0
        times.append(dt)
        losses.append(loss)
        records.append({k: float(v) for k, v in metrics.items()})
        i += 1

        if ckpt is not None and i % ckpt_every == 0:
            ckpt.save(i, state, extra={"pipeline": pipeline.state()})

        if i % log_every == 0:
            r50, r99 = step_time_percentiles(times[-100:], device)
            p50, p99 = float(r50.value), float(r99.value)
            percentiles.append({"step": i, "p50": p50, "p99": p99,
                                "passes": int(r50.iters) + int(r99.iters)})
            log_fn(f"[step {i}] loss={loss:.4f} "
                   f"p50={p50*1e3:.1f}ms p99={p99*1e3:.1f}ms "
                   f"(straggler ratio {p99 / max(p50, 1e-9):.2f})")

    if ckpt is not None:
        ckpt.save(steps, state, extra={"pipeline": pipeline.state()})
        ckpt.wait()
    return {"losses": losses, "metrics": records, "times": times,
            "percentiles": percentiles, "state": state, "retries": retries}
