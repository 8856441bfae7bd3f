"""Fault-tolerant checkpointing, ported from ``repro.checkpoint.manager``.

* Atomic: written to ``step_XXXXXXXX.tmp``, then ``os.replace``d, so a
  crash never leaves a half checkpoint visible.
* Async: the host snapshot (every tensor copied to numpy) is taken on the
  caller's thread; serialization and IO run on a background thread and
  overlap the next steps.  A failed write raises from :meth:`wait` (and
  the next :meth:`save`).
* Tensors are keyed by path: a ``TrainState`` flattens to
  ``params/<state_dict name>``, ``opt/<optimizer state path>`` (e.g.
  ``opt/m/layers.0.mixer.wq``, ``opt/count``) and ``step``; stored as one
  npz (bf16 as its 16 bits, the dtype in the manifest).
* The manifest holds ``step``, ``keys``, ``dtypes`` and ``extra``.
* Retention: the last ``keep`` checkpoints and every ``keep_every``-th.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "", out=None) -> Dict:
    """``{path: leaf}`` of nested dicts, modules (their named parameters),
    dataclasses (their fields), tensors and Python ints."""
    out = {} if out is None else out
    if dataclasses.is_dataclass(tree):
        tree = {f.name: getattr(tree, f.name)
                for f in dataclasses.fields(tree)}
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}/", out)
        return out
    out[prefix[:-1]] = tree
    return out


def _to_numpy(leaf):
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        return t.numpy(), str(t.dtype).replace("torch.", "")
    arr = np.asarray(leaf)
    return arr, f"python {type(leaf).__name__}"


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 keep_every: int = 0, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.keep_every = keep_every
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, *, extra: Optional[Dict] = None):
        """Snapshot ``tree`` at ``step``; non-blocking when async."""
        self.wait()  # one in-flight save at a time
        arrays, dtypes = {}, {}
        for key, leaf in _flatten(tree).items():  # the consistent snapshot
            arrays[key], dtypes[key] = _to_numpy(leaf)
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(arrays),
            "dtypes": dtypes,
            "shards": "full",
            "extra": extra or {},
        }

        def work():
            tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
            final = os.path.join(self.dir, f"step_{step:08d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic publish
            self._gc()

        def guarded():
            try:
                work()
            except BaseException as e:  # raised again from wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=guarded, daemon=True)
            self._thread.start()
        else:
            work()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------------------------------------------------- restore

    def steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d[5:]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, target):
        """Load into the structure of ``target``: every tensor of the
        checkpoint is checked for shape and dtype against the target's and
        copied into it in place (onto the target's device); Python ints
        (a ``TrainState``'s step) are replaced.  Returns (target,
        manifest)."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        data = np.load(os.path.join(path, "arrays.npz"))
        leaves = _flatten(target)
        ints = {}
        for key, want in leaves.items():
            if key not in data:
                raise KeyError(f"checkpoint missing tensor {key!r}")
            arr = data[key]
            if isinstance(want, torch.Tensor):
                shape, dtype = tuple(want.shape), str(want.dtype).replace(
                    "torch.", "")
            else:
                shape, dtype = (), f"python {type(want).__name__}"
            if tuple(arr.shape) != shape:
                raise ValueError(f"{key}: shape {arr.shape} != target "
                                 f"{shape}")
            if manifest["dtypes"][key] != dtype:
                raise ValueError(f"{key}: dtype {manifest['dtypes'][key]} "
                                 f"!= target {dtype}")
            if not isinstance(want, torch.Tensor):
                ints[key] = int(arr)
                continue
            src = torch.from_numpy(arr)
            if dtype == "bfloat16":
                src = src.view(torch.bfloat16)
            with torch.no_grad():
                want.copy_(src)
        if dataclasses.is_dataclass(target):
            target = dataclasses.replace(target, **{
                k: v for k, v in ints.items() if "/" not in k})
        return target, manifest

    # --------------------------------------------------------------- gc

    def _gc(self):
        steps = self.steps()
        protected = set(steps[-self.keep:]) if self.keep else set(steps)
        if self.keep_every:
            protected |= {s for s in steps if s % self.keep_every == 0}
        for s in steps:
            if s not in protected:
                shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                              ignore_errors=True)
