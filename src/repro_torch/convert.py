"""Crossing point between numpy (and the reference package) and the port.

Input arrays enter the port through :func:`from_numpy`, which places them
on the card unless the caller names another device: nothing slides onto
the CPU silently.  The selection path has no learned parameters; the state
that crosses between the reference and the port is input arrays and
results, so :func:`select_result_from_numpy` carries a result across,
and :func:`prior_from_numpy` a warm-start prior.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.selection import Prior, SelectResult


def from_numpy(x, device=None) -> torch.Tensor:
    """A tensor with ``x``'s values and dtype on ``device``.

    ``device=None`` means the card (``cuda``) and raises when no GPU is
    present; the CPU must be asked for by name (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("from_numpy places data on the GPU by default "
                               "and no CUDA device is available; pass "
                               "device='cpu' to compute on the CPU")
        device = "cuda"
    # a copy: the tensor never aliases the caller's (possibly read-only)
    # array
    return torch.tensor(np.asarray(x), device=device)


def select_result_from_numpy(res, device=None) -> SelectResult:
    """The port's :class:`SelectResult` from any object with the fields
    ``value, iters, status, y_lo, y_hi, n_in`` as numpy arrays (for
    example the reference's result after ``np.asarray`` on each field)."""
    return SelectResult(*(from_numpy(np.asarray(getattr(res, f)), device)
                          for f in SelectResult._fields))


def prior_from_numpy(prior, device=None) -> Prior:
    """The port's warm-start :class:`Prior` from any object with the fields
    ``value, y_lo, y_hi`` and, optionally, ``cut`` as numpy arrays (the
    reference's ``Prior``, or its ``SelectResult``, whose answer doubles as
    the cut)."""
    cut = getattr(prior, "cut", None)
    return Prior(*(from_numpy(np.asarray(v), device) for v in (
        prior.value, prior.y_lo, prior.y_hi,
        prior.value if cut is None else cut)))
