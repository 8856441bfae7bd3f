"""Drifting-stream re-selection: carry a warm-start prior across ticks.

The PyTorch port of ``repro.core.stream``.  A stream that re-selects the
same order statistic on slowly drifting data (sliding windows, sensor
feeds, solver loops) pays a cold full-range bracket descent every tick if
each call starts fresh.  :func:`reselect` and :class:`QuantileTracker`
thread the warm-start carry (:class:`repro_torch.core.selection.Prior`)
from each tick's result into the next tick's call: when the answer moved
little, the prior's edge ladder resolves the new selection in ONE binned
sweep (the ``prev_float(value)``/``value`` pair certifies an unchanged
answer at once).  The prior only steers edge placement, so a tick whose
data jumped, or a stale prior, costs sweeps, never exactness.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import selection


def reselect(x: torch.Tensor, k, *, prior=None, weights=None, **kw):
    """One warm tick: the k-th order statistic of ``x`` (with ``weights``,
    the smallest element whose cumulative weight reaches ``k``) seeded by
    ``prior``; returns ``(result, next_prior)``.

    ``prior`` is anything :func:`selection.as_prior` takes — the previous
    tick's result, a :class:`~repro_torch.core.selection.Prior`, a bare
    value — or ``None`` for a cold start::

        res, pr = reselect(x0, k)            # cold
        res, pr = reselect(x1, k, prior=pr)  # warm: 1 sweep if drift small

    Other keyword arguments (``method=``, ``nbins=``, ...) go to the
    selection call.
    """
    if weights is None:
        res = selection.order_statistic(x, k, prior=prior, **kw)
    else:
        res = selection.weighted_order_statistic(x, weights, k, prior=prior,
                                                 **kw)
    return res, selection.as_prior(res)


class QuantileTracker:
    """Stateful quantile tracker over a drifting stream.

    Each :meth:`update` re-selects the q-quantile of the new batch, warm-
    started from the previous tick's realized bracket::

        t = QuantileTracker(0.5, method="binned")
        for batch in stream:
            med = t.update(batch).value

    ``sweeps`` records each tick's sweep (or pass) count as a host int —
    1 in the steady state of a slowly drifting stream.  Every tick's value
    equals a cold ``selection.quantile`` call on the same batch, bit for
    bit.
    """

    def __init__(self, q: float = 0.5, *, weighted: bool = False, **kw):
        self.q = q
        self.weighted = weighted
        self.kw = kw
        self.prior: Optional[selection.Prior] = None
        self.sweeps: list[int] = []

    def update(self, x: torch.Tensor, weights=None) -> selection.SelectResult:
        """Re-select on a new batch; returns the exact result."""
        x = x.reshape(-1)
        if self.weighted or weights is not None:
            w = (torch.ones_like(x) if weights is None
                 else torch.as_tensor(weights, device=x.device).reshape(-1))
            res = selection.weighted_quantile(x, w, self.q, prior=self.prior,
                                              **self.kw)
        else:
            res = selection.quantile(x, self.q, prior=self.prior, **self.kw)
        self.prior = selection.as_prior(res)
        self.sweeps.append(int(res.iters))
        return res

    def reset(self) -> None:
        """Drop the carry: the next update is a cold start."""
        self.prior = None
        self.sweeps.clear()


__all__ = ["reselect", "QuantileTracker"]
