"""Deterministic, resumable synthetic data pipeline, ported from
``repro.data.pipeline``.

``batch = f(seed, step)`` is a pure function (the reference's numpy draws,
number for number), so recovery from a checkpoint replays the exact stream
with no iterator state beyond the step counter.  A background thread keeps
``prefetch`` batches ahead.  Batches are numpy arrays on the host; the
train step moves them to the decoder's device.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


def batch_for_shape(cfg: ModelConfig, shape: ShapeConfig, *, seed: int,
                    step: int, batch_override: Optional[int] = None):
    """Pure function (seed, step) -> batch dict (numpy, host-side)."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step, 0xBEEF]))
    if cfg.family == "encdec":
        return {
            "audio": rng.standard_normal((B, S, cfg.d_model)).astype(
                np.float32) * 0.02,
            "tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32),
        }
    if cfg.frontend == "patch_stub":
        n_img = min(cfg.n_frontend_tokens, S - 1)
        return {
            "patches": rng.standard_normal((B, n_img, cfg.d_model)).astype(
                np.float32) * 0.02,
            "tokens": rng.integers(0, cfg.vocab, (B, S - n_img),
                                   dtype=np.int32),
        }
    return {"tokens": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}


class SyntheticPipeline:
    """Resumable iterator with background prefetch.

    ``state()`` -> ``{'step', 'seed'}``; restore by constructing with
    ``start_step``, or move an open pipeline with :meth:`seek` (the
    reference's loop only resets its counter on a retry, so its worker
    goes on from where it was; here the next batch is the one for the
    step).  :meth:`close` stops the worker.
    """

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, *, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2,
                 batch_override: Optional[int] = None):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.batch_override = batch_override
        self.prefetch = prefetch
        self._thread: Optional[threading.Thread] = None
        self.seek(start_step)

    def _worker(self, q: queue.Queue, stop: threading.Event, step: int):
        while not stop.is_set():
            b = batch_for_shape(self.cfg, self.shape, seed=self.seed,
                                step=step,
                                batch_override=self.batch_override)
            step += 1
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def seek(self, step: int) -> None:
        """Make ``step``'s batch the next one (restarts the worker)."""
        self.close()
        self.step = step
        self._q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._worker, args=(self._q, self._stop, step),
            daemon=True)
        self._thread.start()

    def __next__(self):
        b = self._q.get()
        self.step += 1
        return b

    def __iter__(self) -> Iterator:
        return self

    def state(self):
        return {"step": self.step, "seed": self.seed}

    def close(self):
        if self._thread is not None:
            self._stop.set()
            self._thread.join()
            self._thread = None
