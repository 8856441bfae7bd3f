"""Convex selection objective of Beliakov (2011), Eqs. (1)-(2), both measures.

The k-th smallest element of ``x`` (1-indexed) is the minimizer of the
piecewise-linear convex function

    f(y) = (1/n) * sum_i u(x_i - y),
    u(t) = beta * t        if t >= 0          (x_i above y)
         = -alpha * t      if t <  0          (x_i below y)

with ``alpha = (n - k + 1/2)/n`` and ``beta = (k - 1/2)/n`` (the paper's
Eq. (2) swaps them; these are the corrected weights).  The Clarke
subdifferential at ``y`` is ``[g_lo, g_hi]`` with

    g_lo(y) = alpha * n_lt - beta * (n - n_lt)
    g_hi(y) = alpha * n_le - beta * (n - n_le)

and ``0 in [g_lo, g_hi]  <=>  n_lt < k <= n_le  <=>  y == x_(k)``, so the
counts both drive the optimizer and certify exactness.

The selection engine in :mod:`repro_torch.core.selection` never touches the
data directly; it talks to an :class:`Evaluator`, which answers one question
per iteration — ``evaluator(y: (B,) pivots) -> FG`` with ``(B,)`` fields —
plus the binned pass ``histogram(edges, need_msum)``.  On the counting leg
every element has mass 1, so the measure fields ``m_lt`` / ``m_le`` alias the
int32 counts and every decision is an exact integer comparison.  On the
weighted leg (``weights=`` on either evaluator) element ``i`` has mass
``w_i``: the target ``k`` is a cumulative mass, the measure fields carry
f32 (or f64) masses and the slopes put the subdifferential's zero at mass
``k`` (:func:`wfg_from_partials`).  :class:`RowsEvaluator` and
:class:`SharedEvaluator` own their data; :class:`ShardedEvaluator` owns
one rank's shard of an array sharded over ``torch.distributed`` process
groups (the distributed layer, :mod:`repro_torch.core.distributed`);
:class:`FnEvaluator` wraps closures (segmented selection's, over a
segment-sorted layout, and the distributed layer's).
"""
from __future__ import annotations

import inspect
from typing import Callable, NamedTuple, Optional, Protocol

import torch

from repro_torch.core import collectives
from repro_torch.kernels import ops
from repro_torch.kernels.ref import _accum_dtype, _waccum_dtype


class FG(NamedTuple):
    """Objective value, subdifferential interval and measure at a pivot.

    ``m_lt`` / ``m_le`` carry the measure below / at-or-below the pivot and
    drive every move / exact-hit decision; on the counting leg they alias
    the int32 element counts ``n_lt`` / ``n_le``, which also drive the
    cap-based stopping rule.
    """

    f: torch.Tensor      # objective value (normalized by n)
    g_lo: torch.Tensor   # left one-sided derivative
    g_hi: torch.Tensor   # right one-sided derivative
    m_lt: torch.Tensor   # measure(x <  y) — drives narrowing + certificates
    m_le: torch.Tensor   # measure(x <= y)
    n_lt: torch.Tensor   # count(x <  y), int32 — drives the cap stopping rule
    n_le: torch.Tensor   # count(x <= y), int32


# The weighted septuple is the same type (its measure fields carry masses).
WFG = FG


def os_weights(n, k, dtype=torch.float32):
    """Normalized slope weights (alpha: below-pivot, beta: above-pivot)."""
    n = torch.as_tensor(n).to(dtype)
    k = torch.as_tensor(k).to(dtype)
    alpha = (n - k + 0.5) / n
    beta = (k - 0.5) / n
    return alpha, beta


def eval_partials(x: torch.Tensor, y):
    """One fused pass: ``(sum of (x-y)+, sum of (y-x)+, n_lt, n_le)`` of
    all of ``x`` at the pivot ``y``; the sums in ``x``'s dtype, the counts
    int32.  The four partials are additive over blocks and shards."""
    x = x.reshape(-1)
    d = x - torch.as_tensor(y, dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return (torch.sum(torch.maximum(d, zero), dtype=x.dtype),
            torch.sum(torch.maximum(-d, zero), dtype=x.dtype),
            torch.sum(d < 0, dtype=torch.int32),
            torch.sum(d <= 0, dtype=torch.int32))


def fg_from_partials(partials, n, k) -> FG:
    """Combine the four counting-measure partials into :class:`FG`.

    The measure fields alias the integer counts (counts ARE the measure on
    this leg), so every downstream comparison is an exact int32 comparison.
    """
    sum_pos, sum_neg, n_lt, n_le = partials
    dt = sum_pos.dtype
    alpha, beta = os_weights(n, k, dt)
    nf = torch.as_tensor(n).to(dt)
    f = (beta * sum_pos + alpha * sum_neg) / nf
    n_ltf = n_lt.to(dt)
    n_lef = n_le.to(dt)
    # one-sided derivatives: at x==y the term switches branch, so the left
    # derivative counts ties as "above" and the right derivative as "below".
    g_lo = alpha * n_ltf / nf - beta * (nf - n_ltf) / nf
    g_hi = alpha * n_lef / nf - beta * (nf - n_lef) / nf
    return FG(f=f, g_lo=g_lo, g_hi=g_hi, m_lt=n_lt, m_le=n_le,
              n_lt=n_lt, n_le=n_le)


def eval_fg(x: torch.Tensor, y, k) -> FG:
    """Objective, subdifferential and counts of all of ``x`` at the pivot
    ``y`` for the 1-indexed rank ``k`` (one pass)."""
    return fg_from_partials(eval_partials(x, y), x.numel(), k)


def eval_fg_batched(x: torch.Tensor, y, k) -> FG:
    """Row-wise :func:`eval_fg`: ``x`` is (B, n), ``y`` and ``k`` (B,) (or
    scalars); the batch is a dimension of the reductions."""
    b, n = x.shape
    y = torch.as_tensor(y, dtype=x.dtype, device=x.device).broadcast_to((b,))
    d = x - y[:, None]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    partials = (torch.sum(torch.maximum(d, zero), dim=1, dtype=x.dtype),
                torch.sum(torch.maximum(-d, zero), dim=1, dtype=x.dtype),
                torch.sum(d < 0, dim=1, dtype=torch.int32),
                torch.sum(d <= 0, dim=1, dtype=torch.int32))
    k = torch.as_tensor(k, device=x.device).broadcast_to((b,))
    return fg_from_partials(partials, n, k)


def wfg_from_partials(partials, W, wk) -> FG:
    """Combine the six weight-measure partials into :class:`FG`.

    The slopes ``alpha = (W - wk)/W`` and ``beta = wk/W`` put the
    subdifferential zero-crossing of ``F_w(y) = sum_i w_i * rho(x_i - y)``
    exactly at mass ``wk``, and the normalized one-sided derivatives
    collapse to ``g_lo = (W_lt - wk)/W`` and ``g_hi = (W_le - wk)/W``.
    """
    wsum_pos, wsum_neg, w_lt, w_le, n_lt, n_le = partials
    dt = wsum_pos.dtype
    Wf = torch.as_tensor(W).to(dt)
    wkf = torch.as_tensor(wk).to(dt)
    alpha = (Wf - wkf) / Wf
    beta = wkf / Wf
    f = (beta * wsum_pos + alpha * wsum_neg) / Wf
    g_lo = (w_lt - wkf) / Wf
    g_hi = (w_le - wkf) / Wf
    return FG(f=f, g_lo=g_lo, g_hi=g_hi, m_lt=w_lt, m_le=w_le,
              n_lt=n_lt, n_le=n_le)


def _weight_accum_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    """Mass accumulation dtype: the kernels' f32 floor, full precision for
    either-f64 operands.  The single source is the plain versions'
    ``_waccum_dtype``: the engine's ``wk``/``W`` dtype must never differ
    from the passes' accumulation dtype, or the weighted certificates
    lie."""
    return _waccum_dtype(x, w)


def compiled_mean(x: torch.Tensor, rows: bool = False) -> torch.Tensor:
    """Mean of ``x`` (of each row of a (B, n) ``x`` with ``rows``, else of
    all of it) in ``x``'s dtype, formed as the reference's compiled code
    forms it: the sum in the accumulation dtype times the reciprocal of
    ``n`` rounded to that dtype (XLA turns the division by the constant
    ``n`` into that product).  It seeds the analytic cuts, so the polish's
    first cut matches the reference's bit for bit wherever the sum is
    exact.  A row's sum does not depend on the other rows
    (``ops.row_sums``)."""
    acc = _accum_dtype(x)
    n = x.shape[1] if rows else x.numel()
    # the reciprocal rounded to the accumulation dtype on the host: a
    # Python scalar operand, so nothing is copied to the device
    rcp = float(torch.ones((), dtype=acc) / torch.tensor(float(n), dtype=acc))
    total = ops.row_sums(x, dtype=acc) if rows else torch.sum(x, dtype=acc)
    return (total * rcp).to(x.dtype)


class Evaluator(Protocol):
    """Batched pivot evaluation: pivots ``(B,)`` -> :class:`FG` with ``(B,)``
    fields.  ``n`` is the per-problem element count, ``k`` the target
    measure ``(B,)`` — 1-indexed int32 ranks on the counting leg, float
    cumulative masses on the weighted leg (``weighted`` says which; there
    ``W`` is the total mass).  ``init_stats`` returns per-problem ``(min,
    max, mean)``, the mean mass-weighted on the weighted leg.

    ``histogram`` bins each problem's data against the caller-supplied
    REALIZED edges ``(B, nbins + 1)`` — built once per sweep by the engine
    (``kernels.ref.bin_edges``, or ``selection.polish_edges`` /
    ``selection.prior_edges``); implementations only COMPARE against
    them and accept any sorted, possibly duplicated edge array — and
    returns additive ``(cnt, mass, msum)`` slot vectors of shape
    ``(B, nbins + 2)``: int32 counts, the per-slot measure (``cnt`` itself
    on the counting leg, the weight mass on the weighted leg) and, with
    ``need_msum``, the per-slot sums of ``x`` (of ``w*x`` on the weighted
    leg), else ``None``: only the in-bin polish reads them.
    """

    n: int
    k: torch.Tensor
    weighted: bool

    def __call__(self, y: torch.Tensor) -> FG: ...

    def init_stats(self) -> tuple[torch.Tensor, torch.Tensor,
                                  torch.Tensor]: ...

    def histogram(
        self, edges: torch.Tensor, need_msum: bool = False,
        full_bracket: bool = False
    ) -> tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]: ...


class RowsEvaluator:
    """Independent rows: ``x`` is (B, n), one pivot and one ``k`` per row.

    The data passes are ``kernels.ops.fused_partials_batched`` and
    ``kernels.ops.fused_histogram_batched`` (their weighted twins with
    ``weights``): the CUDA kernels for f32/bf16 tensors on the card, the
    plain versions on the CPU and for f64.  A strided view is copied once
    to contiguous memory, as the kernels read rows of ``n`` consecutive
    elements.

    The weights leg: with ``weights`` (broadcast to (B, n), on ``x``'s
    device), ``k`` is the per-row TARGET CUMULATIVE MASS, in the mass
    accumulation dtype and clipped to the row's total weight ``W``; the
    partials carry weight masses in the measure fields and ``histogram``
    returns ``(cnt, mass, msum)``.
    """

    def __init__(self, x: torch.Tensor, k, weights=None):
        self.x = x.contiguous()
        self.n = int(x.shape[1])
        self.weighted = weights is not None
        if self.weighted:
            self.w = torch.as_tensor(weights, device=x.device).broadcast_to(
                x.shape).contiguous()
            dt = _weight_accum_dtype(x, self.w)
            # each row's total alone: its bits do not follow the batch
            self.W = ops.row_sums(self.x, self.w, dtype=dt)
            self.k = torch.minimum(torch.as_tensor(k, dtype=dt,
                                                   device=x.device), self.W
                                   ).broadcast_to((x.shape[0],))
        else:
            self.k = torch.clamp(
                torch.as_tensor(k, device=x.device).to(torch.int32), 1,
                self.n).broadcast_to((x.shape[0],))

    def __call__(self, y: torch.Tensor) -> FG:
        if self.weighted:
            return wfg_from_partials(
                ops.fused_weighted_partials_batched(self.x, self.w, y),
                self.W, self.k)
        return fg_from_partials(ops.fused_partials_batched(self.x, y),
                                self.n, self.k)

    def histogram(self, edges, need_msum=False, full_bracket=False):
        # full_bracket (every element lies in its row's bracket) picks the
        # row kernel's design on the card
        if self.weighted:
            return ops.fused_weighted_histogram_batched(
                self.x, self.w, edges, want_sums=need_msum,
                full_bracket=full_bracket)
        cnt, bsum = ops.fused_histogram_batched(
            self.x, edges, want_sums=need_msum, full_bracket=full_bracket)
        return cnt, cnt, bsum  # counting measure: the counts ARE the mass

    def init_stats(self):
        x = self.x
        if self.weighted:
            # weighted mean: the analytic seed f-values are mass-weighted
            wmean = ops.row_sums(x, self.w, mode="moment",
                                 dtype=self.W.dtype) \
                / torch.clamp(self.W, min=1e-30)
            return (torch.amin(x, dim=1), torch.amax(x, dim=1),
                    wmean.to(x.dtype))
        return (torch.amin(x, dim=1), torch.amax(x, dim=1),
                compiled_mean(x, rows=True))


class SharedEvaluator:
    """One shared array, K targets (``multi_order_statistic``).

    The data passes are ``kernels.ops.fused_partials_multi`` and
    ``kernels.ops.fused_histogram_multi`` (their weighted twins with
    ``weights``): on the card each reads ``x`` (and ``w``) once for all K
    pivots or ladders (kernels K4 and K3), on the CPU the plain versions
    take one pivot or ladder at a time.  No ``(K, n)`` tensor exists.  A
    strided view is copied once to contiguous memory.  The weights leg as
    :class:`RowsEvaluator`'s, with one total mass ``W``.
    """

    def __init__(self, x: torch.Tensor, ks, weights=None):
        self.x = x.reshape(-1).contiguous()
        self.n = int(self.x.numel())
        self.weighted = weights is not None
        if self.weighted:
            self.w = torch.as_tensor(weights, device=x.device).reshape(
                -1).broadcast_to(self.x.shape).contiguous()
            dt = _weight_accum_dtype(self.x, self.w)
            self.W = torch.sum(self.w, dtype=dt)
            self.k = torch.minimum(torch.as_tensor(
                ks, dtype=dt, device=x.device).reshape(-1), self.W)
        else:
            self.k = torch.clamp(
                torch.as_tensor(ks, device=x.device).reshape(-1), 1, self.n
            ).to(torch.int32)

    def __call__(self, y: torch.Tensor) -> FG:
        if self.weighted:
            return wfg_from_partials(
                ops.fused_weighted_partials_multi(self.x, self.w, y),
                self.W, self.k)
        return fg_from_partials(ops.fused_partials_multi(self.x, y),
                                self.n, self.k)

    def histogram(self, edges, need_msum=False, full_bracket=False):
        # full_bracket lets a first sweep of identical ladders bin the one
        # ladder on the card (a ladder's bits do not follow its company)
        if self.weighted:
            return ops.fused_weighted_histogram_multi(
                self.x, self.w, edges, want_sums=need_msum,
                full_bracket=full_bracket)
        cnt, bsum = ops.fused_histogram_multi(self.x, edges,
                                              want_sums=need_msum,
                                              full_bracket=full_bracket)
        return cnt, cnt, bsum  # counting measure: the counts ARE the mass

    def init_stats(self):
        x, shape = self.x, self.k.shape
        if self.weighted:
            wmean = torch.sum(self.w * x, dtype=self.W.dtype) \
                / torch.clamp(self.W, min=1e-30)
            mean = wmean.to(x.dtype)
        else:
            mean = compiled_mean(x)
        return (torch.amin(x).broadcast_to(shape),
                torch.amax(x).broadcast_to(shape), mean.broadcast_to(shape))


class ShardedEvaluator:
    """This rank's shard of a 1-D array sharded over process groups: the
    local fused pass, then a cross-rank sum of the additive partials.

    ``B = 1`` view (a scalar pivot, 0-dim fields).  ``axes`` names the
    groups (:mod:`repro_torch.core.collectives`: a ``ProcessGroup``, a
    sequence of them, or ``None`` for the default group); every rank of
    them constructs its evaluator and calls it in the same order.  No data
    moves: the local passes are ``kernels.ops.fused_partials`` /
    ``fused_histogram`` (their weighted twins with ``weights``, sharded
    like the data), the K=1 views of kernels K4 and K3 on the card, and
    the combine sums their small outputs across ranks
    (:func:`collectives.psum`: integers exactly, f32 in rank order).  ``n``
    is the global element count, ``W`` the global mass, ``k`` the target
    (clipped as in :class:`SharedEvaluator`).
    """

    def __init__(self, x_local: torch.Tensor, k, axes, *, weights=None):
        self.x_local = x = x_local.reshape(-1).contiguous()
        self.axes = axes
        dev = x.device
        self.n = int(collectives.psum(
            torch.tensor(x.numel(), dtype=torch.int64, device=dev), axes))
        self.weighted = weights is not None
        if self.weighted:
            self.w_local = w = torch.as_tensor(weights, device=dev).reshape(
                -1).broadcast_to(x.shape).contiguous()
            dt = _weight_accum_dtype(x, w)
            # the total mass is a cross-rank sum, as the element count
            self.W = collectives.psum(torch.sum(w, dtype=dt), axes)
            self.k = torch.minimum(torch.as_tensor(k, dtype=dt, device=dev),
                                   self.W)
        else:
            self.k = torch.clamp(torch.as_tensor(k, device=dev).to(
                torch.int64), 1, self.n).to(torch.int32)

    def __call__(self, y: torch.Tensor) -> FG:
        return self.combine(self.local_partials(y))

    def local_partials(self, y: torch.Tensor):
        """This shard's partials at the pivot ``y``, not yet summed across
        ranks (the distributed finalize bounds the PER-SHARD in-bracket
        count from them)."""
        if self.weighted:
            return ops.fused_weighted_partials(self.x_local, self.w_local, y)
        return ops.fused_partials(self.x_local, y)

    def combine(self, partials) -> FG:
        """The cross-rank combine of the additive partials (the paper's
        "partial sums from several GPUs are added"): four for counts, six
        for the weighted leg."""
        if self.weighted:
            wsp, wsn, wlt, wle, lt, le = partials
            f = collectives.psum(torch.stack([wsp, wsn, wlt, wle]), self.axes)
            c = collectives.psum(torch.stack([lt, le]), self.axes)
            return wfg_from_partials((f[0], f[1], f[2], f[3], c[0], c[1]),
                                     self.W, self.k)
        sp, sn, lt, le = partials
        f = collectives.psum(torch.stack([sp, sn]), self.axes)
        c = collectives.psum(torch.stack([lt, le]), self.axes)
        return fg_from_partials((f[0], f[1], c[0], c[1]), self.n, self.k)

    def local_histogram(self, edges, need_msum=False):
        """This shard's ``(cnt, mass, msum)`` slot vectors against one
        ladder ``(nbins + 1,)``, not yet summed across ranks; ``msum`` only
        with ``need_msum`` (the polish)."""
        if self.weighted:
            return ops.fused_weighted_histogram(
                self.x_local, self.w_local, edges, want_sums=need_msum)
        cnt, bsum = ops.fused_histogram(self.x_local, edges,
                                        want_sums=need_msum)
        return cnt, cnt, bsum  # counting measure: the counts ARE the mass

    def histogram(self, edges, need_msum=False, full_bracket=False):
        """The binned pass over the GLOBAL array: the local histogram, then
        its slot vectors summed across ranks (the per-slot sums only with
        ``need_msum``)."""
        cnt, mass, msum = self.local_histogram(edges, need_msum=need_msum)
        c = collectives.psum(cnt, self.axes)
        m = c if mass is cnt else collectives.psum(mass, self.axes)
        return c, m, (collectives.psum(msum, self.axes) if need_msum
                      else None)

    def init_stats(self):
        """Global ``(min, max, mean)``, the mean mass-weighted on the
        weighted leg; its sum in the accumulation dtype, summed across
        ranks in rank order."""
        x, axes = self.x_local, self.axes
        xmin = collectives.pmin(torch.amin(x), axes)
        xmax = collectives.pmax(torch.amax(x), axes)
        if self.weighted:
            wx = collectives.psum(torch.sum(self.w_local * x,
                                            dtype=self.W.dtype), axes)
            mean = wx / torch.clamp(self.W, min=1e-30)
        else:
            mean = collectives.psum(torch.sum(x, dtype=_accum_dtype(x)),
                                    axes) / self.n
        return xmin, xmax, mean.to(x.dtype)


class FnEvaluator:
    """Adapter: a raw ``partials(y) -> (sp, sn, lt, le)`` closure (every
    field ``(B,)``) as an :class:`Evaluator`.  Segmented selection builds
    one (``selection.segmented_order_statistic``), as may a caller that
    drives the engine through its own data layout.

    ``histogram(edges) -> (cnt, mass, msum)`` (edges ``(B, nbins + 1)``,
    outputs ``(B, nbins + 2)``, ``msum`` possibly ``None``) is optional;
    without it the evaluator drives only the cp family.  A closure that
    takes a ``need_msum`` keyword sees the engine's demand for the
    per-slot sums (the polish sweeps); a one-argument closure does not,
    and one that always returns ``None`` for ``msum`` cannot drive the
    polish.  The engine's ``full_bracket`` hint (a kernel design choice)
    is not passed on.

    ``n`` is the element count per problem (an int or a ``(B,)`` tensor),
    ``k`` the target.  Weighted leg: with ``weights_total=W`` the
    ``partials`` closure returns the six weighted partials, ``k`` is the
    target mass and the histogram's ``mass`` the weighted slot masses."""

    def __init__(self, partials: Callable, n, k, init_stats: Callable,
                 histogram: Optional[Callable] = None,
                 weights_total=None):
        self._partials = partials
        self.n = n
        self.k = k
        self._init_stats = init_stats
        self._histogram = histogram
        self._hist_takes_msum = False
        if histogram is not None:
            try:
                params = inspect.signature(histogram).parameters
                self._hist_takes_msum = "need_msum" in params
            except (TypeError, ValueError):  # builtins / odd callables
                self._hist_takes_msum = False
        self.weighted = weights_total is not None
        self.W = weights_total

    def __call__(self, y: torch.Tensor) -> FG:
        if self.weighted:
            return wfg_from_partials(self._partials(y), self.W, self.k)
        return fg_from_partials(self._partials(y), self.n, self.k)

    def histogram(self, edges, need_msum=False, full_bracket=False):
        if self._histogram is None:
            raise NotImplementedError(
                "this FnEvaluator was built without a histogram closure; "
                "method='binned' needs one")
        if self._hist_takes_msum:
            return self._histogram(edges, need_msum=need_msum)
        return self._histogram(edges)

    def init_stats(self):
        return self._init_stats()
