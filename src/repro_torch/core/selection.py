"""Selection (k-th order statistic) by convex minimization — Beliakov (2011).

The PyTorch port of ``repro.core.selection``.  The engine is
batched-first: the bracket loops, the exact-hit certificates and the hybrid
finalize operate on ``(B,)`` state tensors fed by an
:class:`repro_torch.core.objective.Evaluator`; scalar selection is the
``B = 1`` view of :func:`select_rows`, and :func:`multi_order_statistic` /
:func:`quantiles` run K targets of ONE array through the same loops on a
:class:`~repro_torch.core.objective.SharedEvaluator` (kernels K3 and K4 on
the card: one read of the array per sweep or pass for all K).  The
weighted entry points (:func:`weighted_select_rows`,
:func:`weighted_order_statistic`, :func:`weighted_median`,
:func:`weighted_quantile`, :func:`weighted_multi_order_statistic`,
:func:`weighted_quantiles`) run the same loops and finalize on an
evaluator whose measure is the weight mass (kernels K1w-K4w on the card).

Methods (shared skeleton, they differ only in the next-pivot proposal):

* ``binned``    — binned bracket descent (default for ``n >= BINNED_MIN_N``):
  each data pass histograms the live bracket into ``nbins`` sub-intervals
  (kernel K1 on the card), phase 1 runs ~2-3 sweeps until every row's
  in-bracket count is under ``cap``, phase 2 compacts the survivors into a
  ``(B, cap)`` buffer and finalizes exactly;
* ``binned_polish`` — the binned descent with the in-bin CP polish: each
  sweep also sums the values per slot (the sums legs K1s/K3s, K1ws/K3ws
  on the card) and the straddling bin's mass centroid places half of the
  next sweep's edges around it (:func:`polish_edges`);
* ``cp``        — Kelley's cutting-plane method (Algorithm 1 of the paper),
  one fused pass (kernel K2 on the card) per iteration; ``cp_hybrid`` is an
  alias;
* ``bisection``, ``golden``, ``brent`` — the paper's baselines on the same
  pass;
* ``sort``      — a full sort (the paper's "GPU radix sort" baseline).

Exactness: the loops carry the measure per row (integer counts, or
weight masses on the weighted leg), which yields the exact-hit certificate
``m_lt < k <= m_le  =>  pivot == x_(k)`` and the tie fallback (next
distinct value above ``y_L`` verified by one pass); the integer counts ride
along on both legs for the stopping rule ``count(y_L < x <= y_R) <= cap``
that sizes the static ``(B, cap)`` compaction.  Invariant per row:
``measure(x <= y_L) < k <= measure(x <= y_R)``.  With exactly summable
weights (integers, dyadic rationals with a bounded total) every mass
comparison is exact, and uniform weights reproduce the counting leg bit
for bit; with other weights the masses are f32 sums, and a decision near
``k`` can flip with the order of summation, which the certificates fail
safe against (a late ``hit_lo`` stalls, the finalize re-measures).

PyTorch idiom: the reference's ``lax.while_loop`` is a host loop with one
``bool(live.any())`` device sync per sweep or iteration, and its ``vmap``
over rows is a batch dimension written out.  Brackets of bf16 data are
carried in f32 and kept ``(B, 1)``-shaped where they meet the data, so the
comparisons run in f32 (torch would compare a bf16 tensor with a 0-dim f32
tensor in bf16).

Warm starts: every public entry point takes ``prior=`` (a previous
:class:`SelectResult`, a :class:`Prior` or a bare value; see
:func:`as_prior`).  The prior places the first sweep's edges
(:func:`prior_edges`) or the first cp pivot and nothing else, so a warm
answer equals the cold one bit for bit and an unchanged answer
re-certifies in one sweep; ``core/stream.py`` carries it across the ticks
of a stream.

Segmented selection (:func:`segmented_order_statistic`,
:func:`segmented_quantiles`: per-segment order statistics of one
concatenated array, the per-leaf regime) runs the same loops on a
:class:`~repro_torch.core.objective.FnEvaluator` over a segment-sorted
layout, in plain torch.

The distributed layer (``ShardedEvaluator``, :mod:`repro_torch.core.
distributed`) runs these loops on evaluators whose combine is a
``torch.distributed`` collective.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import transforms
from repro_torch.core.objective import (FG, Evaluator, FnEvaluator,
                                        RowsEvaluator, SharedEvaluator,
                                        _weight_accum_dtype, os_weights)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (GroupPlan, _accum_dtype, bin_edges,
                                     segmented_histogram_ref)

METHODS = ("binned", "binned_polish", "cp", "cp_hybrid", "bisection",
           "golden", "brent", "sort")

# method=None resolution: histogram sweeps win once the O(n) data pass
# dominates (~3 sweeps vs ~15 CP passes); below this the per-sweep bin
# bookkeeping isn't worth it and Kelley cuts converge in a few passes.
BINNED_MIN_N = 1 << 16

# Sub-intervals per histogram sweep on the kernel path (one sweep =
# log2(128) = 7 bisection-equivalents of bracket narrowing).
DEF_NBINS = 128

# Plain-version default (CPU tensors and f64), equal to the reference's
# jnp-path default so that CPU runs take the reference's sweeps.
DEF_NBINS_JNP = 16

# Status codes for SelectResult.status
EXACT_HIT = 0       # pivot certified equal to x_(k) during iterations
HYBRID_SORT = 1     # answer from compact+sort of the pivot interval
TIE_FALLBACK = 2    # answer = next distinct value, certified by counts
NOT_CONVERGED = 3   # approximate answer (bracket right end)


class SelectResult(NamedTuple):
    value: torch.Tensor   # the order statistic (exact unless status==3)
    iters: torch.Tensor   # number of data passes this row was live for
    status: torch.Tensor  # see codes above
    y_lo: torch.Tensor    # final bracket
    y_hi: torch.Tensor
    n_in: torch.Tensor    # count(y_lo < x <= y_hi) at exit


class Prior(NamedTuple):
    """Warm-start carry for repeated selection (``prior=`` on every public
    entry point): the previous answer, its realized bracket and the last
    polish cut, each broadcastable to the solve's batch shape ((B,) rows,
    (K,) shared x, or scalar).

    The prior steers only the FIRST pivot (cp family) or the FIRST sweep's
    edge placement (binned family, :func:`prior_edges`); every narrowing
    decision and every certificate still runs off measured prefix
    invariants, so a stale, garbage, NaN or wrong-array prior costs sweeps,
    never exactness."""
    value: torch.Tensor  # previous answer
    y_lo: torch.Tensor   # realized final bracket, reused verbatim as edges
    y_hi: torch.Tensor
    cut: torch.Tensor    # last polish cut (seeds the carried in-bin cut)


def as_prior(prior) -> Optional[Prior]:
    """Normalize a ``prior=`` argument: ``None`` | :class:`Prior` |
    :class:`SelectResult` (its bracket reused verbatim, the answer doubling
    as the cut) | a bare value (an answer-only seed)."""
    if prior is None or isinstance(prior, Prior):
        return prior
    if isinstance(prior, SelectResult):
        return Prior(value=prior.value, y_lo=prior.y_lo, y_hi=prior.y_hi,
                     cut=prior.value)
    v = torch.as_tensor(prior)
    return Prior(value=v, y_lo=v, y_hi=v, cut=v)


def _prior_to(prior: Prior, dtype, like: torch.Tensor) -> Prior:
    """The prior's fields in ``dtype``, broadcast to ``like``'s shape and
    on its device."""
    return Prior(*(torch.as_tensor(f, device=like.device).to(dtype)
                   .broadcast_to(like.shape) for f in prior))


class BatchState(NamedTuple):
    """Bracket-loop state; every field is (B,)-shaped except the host-side
    global iteration counter ``it``."""
    yL: torch.Tensor
    fL: torch.Tensor
    gL: torch.Tensor    # right one-sided derivative at yL (< 0)
    yR: torch.Tensor
    fR: torch.Tensor
    gR: torch.Tensor    # left one-sided derivative at yR (> 0)
    cleL: torch.Tensor  # lower bound on count(x <= yL)  (exact after 1st move)
    cleR: torch.Tensor  # exact count(x <= yR)
    t_exact: torch.Tensor
    found_exact: torch.Tensor
    iters: torch.Tensor  # per-row live-iteration count
    it: int              # global (batch) iteration count
    # golden/brent bookkeeping: previous probe (for the parabolic fit); the
    # binned polish reuses it as the carried in-bin cut
    tp: torch.Tensor
    fp: torch.Tensor


def _resolve_method(method: Optional[str], n: int) -> str:
    """``None``/``'auto'`` -> 'binned' for ``n >= BINNED_MIN_N``, else 'cp'
    (auto stays on plain 'binned', as in the reference)."""
    if method in (None, "auto"):
        return "binned" if n >= BINNED_MIN_N else "cp"
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; one of {METHODS}")
    return method


def _resolve_nbins(nbins: Optional[int], x: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> int:
    """``None`` -> ``DEF_NBINS`` where the histogram kernel runs (f32/bf16
    on the card, for both operands with weights ``w``), ``DEF_NBINS_JNP``
    where the plain version runs (the CPU, and f64 anywhere — either
    operand on the weighted leg).  Explicit values always win."""
    if nbins is not None:
        return int(nbins)
    kernel = ops.uses_kernel(x) if w is None else ops.uses_kernel_weighted(
        x, w)
    return DEF_NBINS if kernel else DEF_NBINS_JNP


def _propose_cp(s: BatchState):
    """Kelley cut intersection: minimizer of max of the two support lines."""
    return (s.fR - s.fL + s.yL * s.gL - s.yR * s.gR) / (s.gL - s.gR)


def _propose_bisection(s: BatchState):
    return 0.5 * (s.yL + s.yR)


_INV_GOLDEN = 0.381966011250105  # 2 - golden ratio


def _propose_golden(s: BatchState):
    # Shrink from the side whose objective value is larger (descent side).
    left = s.fL > s.fR
    w = torch.full_like(s.yL, 1.0 - _INV_GOLDEN).masked_fill(left, _INV_GOLDEN)
    return s.yL + w * (s.yR - s.yL)


def _propose_brent(s: BatchState):
    """Parabola through (yL,fL), (tp,fp), (yR,fR); midpoint safeguard."""
    x1, f1, x2, f2, x3, f3 = s.yL, s.fL, s.tp, s.fp, s.yR, s.fR
    num = (x2 - x1) ** 2 * (f2 - f3) - (x2 - x3) ** 2 * (f2 - f1)
    den = (x2 - x1) * (f2 - f3) - (x2 - x3) * (f2 - f1)
    ok = torch.abs(den) > 1e-30
    t = x2 - 0.5 * num / torch.where(ok, den, 1.0)
    mid = 0.5 * (s.yL + s.yR)
    inside = (t > s.yL) & (t < s.yR)
    return torch.where(ok & inside, t, mid)


_PROPOSALS = {
    "cp": _propose_cp,
    "cp_hybrid": _propose_cp,
    "bisection": _propose_bisection,
    "golden": _propose_golden,
    "brent": _propose_brent,
}


def _live(s: BatchState, cap):
    return (~s.found_exact) & (s.cleR - s.cleL > cap) & (s.yR > s.yL)


def _seed_state(ev: Evaluator, found0=None, t0=None):
    """Shared loop seed: analytic bracket/cut init from one stats pass.

    Returns ``(s0, xmin, xmax, kk, dtype, xmean)``.  Counting leg: the slopes
    use the paper's normalized weights with the conservative tie count 1,
    which keeps the support lines *lower* bounds (valid cuts) even with
    duplicated extremes.  Weighted leg: the mass-normalized coefficients
    ``alpha = (W - wk)/W`` and ``beta = wk/W`` with the conservative extreme
    slopes ``-wk/W`` / ``(W - wk)/W`` (no mass assumed at the extremes —
    flatter than the truth, so the support lines stay lower bounds); the f
    seeds anchor on the weighted mean, which is returned for the polish's
    first cut (:func:`_seed_cut`).

    ``found0`` / ``t0`` pre-seed rows whose answer is already certified
    (``found_exact`` and ``t_exact``; the across-axis solver certifies the
    extreme ranks before the loop), so those rows never go live.
    """
    xmin, xmax, xmean = ev.init_stats()
    shape = torch.broadcast_shapes(xmin.shape, ev.k.shape)
    dtype = xmin.dtype
    dev = xmin.device
    kk = ev.k.broadcast_to(shape)
    xmin, xmax = xmin.broadcast_to(shape), xmax.broadcast_to(shape)
    xmean = xmean.to(dtype).broadcast_to(shape)

    if ev.weighted:
        Wf = ev.W.to(kk.dtype).broadcast_to(shape)
        Wsafe = torch.clamp(Wf, min=1e-30)
        alpha = ((Wf - kk) / Wsafe).to(dtype)
        beta = (kk / Wsafe).to(dtype)
        gL0, gR0 = -beta, alpha
    else:
        nf = _count_like(ev.n, dtype, shape, dev)
        alpha, beta = os_weights(nf, kk, dtype)
        gL0 = alpha * (1.0 / nf) - beta * (nf - 1.0) / nf
        gR0 = alpha * (nf - 1.0) / nf - beta * (1.0 / nf)

    # Analytic init at the extremes (paper: single fused reduction).
    fL0 = beta * (xmean - xmin)
    fR0 = alpha * (xmax - xmean)

    s0 = BatchState(
        yL=xmin, fL=fL0, gL=gL0,
        yR=xmax, fR=fR0, gR=gR0,
        cleL=torch.ones(shape, dtype=torch.int32, device=dev),
        cleR=_count_like(ev.n, torch.int32, shape, dev),
        t_exact=(torch.full(shape, float("nan"), dtype=dtype, device=dev)
                 if t0 is None else torch.as_tensor(t0, device=dev).to(
                     dtype).broadcast_to(shape)),
        found_exact=(torch.zeros(shape, dtype=torch.bool, device=dev)
                     if found0 is None else torch.as_tensor(
                         found0, device=dev).broadcast_to(shape)),
        iters=torch.zeros(shape, dtype=torch.int32, device=dev),
        it=0,
        tp=0.5 * (xmin + xmax), fp=torch.maximum(fL0, fR0),
    )
    return s0, xmin, xmax, kk, dtype, xmean


def _count_like(n, dtype, shape, device) -> torch.Tensor:
    """The element count ``n`` per problem — an int, or a tensor of one
    count per problem (segmented selection) — in ``dtype``, broadcast to
    ``shape``."""
    if torch.is_tensor(n):
        return n.to(device=device, dtype=dtype).broadcast_to(shape)
    return torch.full(shape, n, dtype=dtype, device=device)


def _fma(a, b, c):
    """``a*b + c`` rounded once to ``a``'s dtype (f32 operands: the product
    is exact in f64, so only the final sum rounds twice, f64 then f32);
    ``b`` may be a Python scalar."""
    wide = torch.float64
    b = b.to(wide) if torch.is_tensor(b) else b
    return (a.to(wide) * b + c.to(wide)).to(a.dtype)


def _seed_cut(ev: Evaluator, kk, xmin, xmax, xmean):
    """The polish's first cut: the Kelley intersection of the support lines
    at the data's extremes, ``(fR - fL + xmin*gL - xmax*gR) / (gL - gR)``,
    in the arithmetic of the reference's compiled seed.  XLA folds the
    constant ``n`` into reciprocals (``c1 = 1/n``, ``c2 = c1*c1``,
    ``c3 = (c1*(n-1))*c1``, each rounded) and contracts each sum whose
    first operand is a product into a fused multiply-add, emulated here by
    :func:`_fma`.  The cut only places edges, so any finite value is sound;
    this form makes the polished sweeps match the reference's bit for bit
    where the stats are exact.  Computed in the data's dtype promoted to
    f32 at least."""
    dt = torch.promote_types(xmin.dtype, torch.float32)
    xmin, xmax, xmean = xmin.to(dt), xmax.to(dt), xmean.to(dt)
    s112, s111 = xmax - xmean, xmean - xmin
    if ev.weighted:
        Wf = ev.W.to(kk.dtype).broadcast_to(kk.shape)
        Wsafe = torch.clamp(Wf, min=1e-30)
        alpha = ((Wf - kk) / Wsafe).to(dt)
        beta = (kk / Wsafe).to(dt)
        gL, gR = -beta, alpha
    else:
        kf = kk.to(dt)
        if torch.is_tensor(ev.n):
            # one count per problem (segmented selection): the same
            # folded constants, per problem on the device
            nf = ev.n.to(device=kk.device, dtype=dt)
            c1 = torch.ones((), dtype=dt, device=kk.device) / nf
            c2, c3 = c1 * c1, (c1 * (nf - 1)) * c1
            s1 = (ev.n.to(device=kk.device, dtype=torch.float64)
                  + 0.5).to(dt) - kf
        else:
            # the folded constants, each rounded to dt on the host (Python
            # scalars: nothing is copied to the device)
            nf = torch.tensor(float(ev.n), dtype=dt)
            c1t = torch.ones((), dtype=dt) / nf
            c1, c2 = float(c1t), float(c1t * c1t)
            c3 = float((c1t * (nf - 1)) * c1t)
            s1 = float(torch.tensor(ev.n + 0.5, dtype=dt)) - kf
        a245 = kf - 0.5
        alpha, beta = s1 * c1, a245 * c1
        gL = _fma(s1, c2, -(a245 * c3))
        gR = _fma(s1, c3, -(a245 * c2))
    num = _fma(alpha, s112, -(beta * s111))      # fR - fL
    num = _fma(xmin, gL, num)                    # + xmin * gL
    num = _fma(-xmax, gR, num)                   # - xmax * gR
    return num / (gL - gR)


def bracket_loop_batched(
    ev: Evaluator,
    *,
    method: str = "cp",
    maxit: int = 64,
    cap=0,
    found0: Optional[torch.Tensor] = None,
    t0: Optional[torch.Tensor] = None,
    prior: Optional[Prior] = None,
):
    """Run the batched bracket-shrinking loop against an evaluator.

    Per live row, one pivot ``t`` per iteration: ``m_lt < k <= m_le``
    certifies ``t`` as the order statistic (on the weighted leg
    ``m_lt < m_le`` forces positive mass at ``t``, so a certified pivot is a
    data element), ``m_le < k`` moves the left end to ``t``, otherwise the
    right end moves; the measure is the evaluator's, compared in its own
    dtype.  Rows stop independently once
    certified or once ``count(y_L < x <= y_R) <= cap``; the loop ends when
    no row is live or after ``maxit`` iterations.  ``found0`` / ``t0``
    pre-seed rows whose answer is already certified, so they never go live
    (:func:`_seed_state`).

    ``prior`` (warm start): the prior answer replaces the FIRST proposal
    only, and only where it is finite and strictly inside the open
    bracket; the measured partials decide every move, so an exact prior
    certifies in one pass and a wrong one costs passes, never exactness.

    Returns ``(final BatchState, xmin, xmax)`` with per-row extremes.
    """
    propose = _PROPOSALS[method]
    s, xmin, xmax, kk, dtype, _ = _seed_state(ev, found0, t0)
    pv0 = None if prior is None else _prior_to(prior, dtype, s.yL).value
    while s.it < maxit:
        lv = _live(s, cap)
        if not bool(lv.any()):
            break
        t = propose(s)
        # numerical safeguard: keep strictly inside the open bracket (frozen
        # rows get the midpoint — their updates are masked out anyway)
        bad = ~torch.isfinite(t) | (t <= s.yL) | (t >= s.yR)
        t = torch.where(bad, 0.5 * (s.yL + s.yR), t).to(dtype)
        if pv0 is not None and s.it == 0:
            use = torch.isfinite(pv0) & (pv0 > s.yL) & (pv0 < s.yR)
            t = torch.where(use, pv0, t)
        fg: FG = ev(t)
        exact = (fg.m_lt < kk) & (kk <= fg.m_le) & lv
        # exact => 0 in [g_lo, g_hi] => g_hi >= 0, so the two are disjoint:
        move_left = (fg.m_le < kk) & lv  # t strictly left of the minimizer
        move_right = lv & ~move_left & ~exact  # then m_lt >= k: right of it
        s = BatchState(
            yL=torch.where(move_left, t, s.yL),
            fL=torch.where(move_left, fg.f, s.fL),
            gL=torch.where(move_left, fg.g_hi, s.gL),
            yR=torch.where(move_right, t, s.yR),
            fR=torch.where(move_right, fg.f, s.fR),
            gR=torch.where(move_right, fg.g_lo, s.gR),
            cleL=torch.where(move_left, fg.n_le, s.cleL),
            cleR=torch.where(move_right, fg.n_le, s.cleR),
            t_exact=torch.where(exact, t, s.t_exact),
            found_exact=s.found_exact | exact,
            iters=s.iters + lv.to(torch.int32),
            it=s.it + 1,
            tp=torch.where(lv, t, s.tp), fp=torch.where(lv, fg.f, s.fp),
        )
    return s, xmin, xmax


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``a[..., i]`` per row (``i`` one index per leading position)."""
    return torch.gather(a, -1, i.to(torch.int64)[..., None])[..., 0]


def binned_descent_step(cum, edges, yL, yR, kk):
    """One binned-descent narrowing decision from prefix counts.

    ``cum[..., j] = count(x <= e_j)`` at the realized ``edges``
    ``(..., nbins+1)`` of the bracket ``[yL, yR]`` — the same array the
    histogram pass binned against.  Returns
    ``(yLn, yRn, cLn, cRn, jm1, jstar, hit_lo, exact, stall)``:

    * ``jstar`` — first edge whose prefix count reaches ``kk``; the answer
      lies in the single bin ``(e_{jstar-1}, e_jstar]``;
    * ``hit_lo`` — ``jstar == 0``, i.e. ``count(x <= yL) >= k``: possible
      only while ``yL`` is the initial minimum, and certifies
      ``x_(k) == yL``;
    * ``exact`` — ``hit_lo`` or ulp-collapse: ``(yLn, yRn]`` holds a single
      representable value, so the invariant certifies ``x_(k) == yRn``;
    * ``stall`` — the chosen bin IS the whole bracket (bin width underflowed
      against denormal-scale data), or the prefix counts contradict the
      bracket invariant (``cum[-1] < k``): freeze the row and let the
      finalize's fallback resolve it.  A violated invariant never certifies.
    """
    reached = cum >= kk[..., None]
    # first maximum of the 0/1 row (argmax on bool is not on every build)
    jstar = torch.argmax(reached.to(torch.int32), dim=-1).to(torch.int32)
    jm1 = torch.clamp(jstar - 1, min=0)
    yLn, yRn = _take(edges, jm1), _take(edges, jstar)
    cLn, cRn = _take(cum, jm1), _take(cum, jstar)
    ok = reached[..., -1]
    hit_lo = (jstar == 0) & reached[..., 0]
    collapse = transforms.next_float(yLn) >= yRn
    exact = (hit_lo | collapse) & ok
    stall = ~exact & (~ok | ((yLn == yL) & (yRn == yR)))
    return yLn, yRn, cLn, cRn, jm1, jstar, hit_lo, exact, stall


def _clip(v, lo, hi):
    """``jnp.clip``: ``min(max(v, lo), hi)``, elementwise and broadcast."""
    return torch.minimum(torch.maximum(v, lo), hi)


def _sorted_edges(parts, lo, hi):
    """The realized edge array from its pieces: sorted (stable, so equal
    values keep their order, -0.0 and 0.0 included) with the endpoints
    pinned to ``lo`` and ``hi`` AFTER the sort."""
    e = torch.sort(torch.cat(parts, dim=-1), dim=-1, stable=True).values
    e[..., 0] = lo
    e[..., -1] = hi
    return e


def polish_edges(lo, hi, t, nbins: int) -> torch.Tensor:
    """CP-centered realized bin edges for one polish sweep.

    Half the edges cover ``[lo, hi]`` uniformly (:func:`bin_edges` with
    ``nbins // 2`` bins: the worst-case shrink of a plain sweep with half
    the bins); the other half sit geometrically around the carried cut
    ``t`` at offsets ``halfwidth * 2^-j``, ``j = 1 .. nbins // 4``, so when
    ``t`` is near the answer the straddling bin comes out orders of
    magnitude narrower than ``1/nbins`` of the bracket.

    Exactness is inherited, not re-proven: the output is a sorted array of
    realized values in ``[lo, hi]`` with ``e_0 == lo`` and
    ``e_nbins == hi`` exactly, built ONCE per sweep and shared by the
    histogram pass and the narrowing decision.  A garbage cut (NaN, out of
    the bracket) degrades to the bracket midpoint; the certificates never
    trust the cut itself.
    """
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi, dtype=lo.dtype, device=lo.device)
    dt = lo.dtype
    nu = nbins // 2
    m = (nbins - nu) // 2
    extra = nbins - nu - 2 * m
    base = bin_edges(lo, hi, nu)                       # (..., nu + 1)
    mid = 0.5 * lo + 0.5 * hi
    t = torch.as_tensor(t, device=lo.device).to(dt)
    tc = _clip(torch.where(torch.isfinite(t), t, mid), lo, hi)
    half = hi / 2 - lo / 2   # overflow-safe half-width (divide BEFORE diff)
    j = torch.arange(1, m + 1, dtype=dt, device=lo.device)
    d = half[..., None] * torch.pow(2.0, -j)
    lo1, hi1 = lo[..., None], hi[..., None]
    parts = [base, _clip(tc[..., None] - d, lo1, hi1),
             _clip(tc[..., None] + d, lo1, hi1)]
    if extra:
        parts.append(tc[..., None].expand(tc.shape + (extra,)))
    return _sorted_edges(parts, lo, hi)


def prior_edges(lo, hi, prior: Prior, nbins: int) -> torch.Tensor:
    """Prior-seeded realized bin edges for the FIRST sweep of a warm solve.

    ``nbins + 1`` edges under the :func:`polish_edges` contract (sorted,
    clipped into ``[lo, hi]``, endpoints pinned after the sort, built once
    and shared by the histogram pass and the narrowing decision):

    * half cover ``[lo, hi]`` uniformly — a garbage prior still buys a
      factor ``nbins/2`` shrink;
    * the prior's realized bracket ends ``y_lo``/``y_hi`` verbatim — on
      unchanged data the straddling bin lands inside the carried bracket,
      already under cap, so the row stops after ONE sweep;
    * the pair ``(prev_float(value), value)`` — an unchanged answer makes
      the straddling bin hold a single representable value, so the
      ulp-collapse certificate of :func:`binned_descent_step` fires: one
      sweep WITH an exact hit;
    * the rest a geometric ladder around ``value`` at offsets ``w0 * 2^j``
      with ``w0 = max(y_hi - y_lo, 1 ulp)``.

    NaN and infinite fields degrade to the bracket midpoint; the prior only
    chooses WHERE edges go.
    """
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi, dtype=lo.dtype, device=lo.device)
    dt = lo.dtype
    mid = 0.5 * lo + 0.5 * hi

    def san(v):
        v = torch.as_tensor(v, device=lo.device).to(dt)
        return _clip(torch.where(torch.isfinite(v), v, mid), lo, hi)

    pv, plo, phi = san(prior.value), san(prior.y_lo), san(prior.y_hi)
    nu = max(nbins // 2, 1)
    r = nbins - nu
    base = bin_edges(lo, hi, nu)                       # (..., nu + 1)
    sharp = [pv, _clip(transforms.prev_float(pv), lo, hi), plo, phi][:r]
    m = (r - len(sharp)) // 2
    extra = r - len(sharp) - 2 * m
    parts = [base]
    if sharp:
        parts.append(torch.stack(torch.broadcast_tensors(*sharp), dim=-1))
    if m > 0:
        fmax = torch.finfo(dt).max
        w0 = torch.maximum(phi - plo, transforms.next_float(pv) - pv)
        w0 = torch.clamp(w0, torch.finfo(dt).tiny, fmax)
        j = torch.arange(m, dtype=dt, device=lo.device)
        d = torch.clamp(w0[..., None] * torch.pow(2.0, j), 0.0, fmax)
        lo1, hi1 = lo[..., None], hi[..., None]
        parts.append(_clip(pv[..., None] - d, lo1, hi1))
        parts.append(_clip(pv[..., None] + d, lo1, hi1))
    if extra:
        parts.append(pv[..., None].expand(pv.shape + (extra,)))
    return _sorted_edges(parts, lo, hi)


def binned_loop_batched(
    ev: Evaluator,
    *,
    nbins: int = DEF_NBINS,
    maxit: int = 16,
    cap=0,
    found0: Optional[torch.Tensor] = None,
    t0: Optional[torch.Tensor] = None,
    polish: bool = False,
    prior: Optional[Prior] = None,
):
    """Phase 1 of the binned two-phase schedule: histogram bracket descent.

    Each sweep builds the bracket's realized edges once
    (``kernels.ref.bin_edges``; :func:`polish_edges` with ``polish``),
    calls ``ev.histogram(edges)`` — ONE fused data pass — and narrows every
    live row's bracket to the single sub-interval ``(e_{j-1}, e_j]`` whose
    prefix MEASURE straddles that row's target (:func:`binned_descent_step`;
    int32 counts, or weight masses on the weighted leg — the decision is
    ordering-only, so both legs take the same path).  Brackets only move to
    REALIZED edge values whose prefix measures were measured, so the row
    invariant ``measure(x <= yL) < k <= measure(x <= yR)`` holds at every
    step.  Integer prefix counts at the chosen edges feed the cap rule on
    both legs: rows stop once their in-bracket count is under ``cap``, on
    the exact certificates, on a stall, or at ``maxit``.  A late ``hit_lo``
    (the invariant forbids it after sweep 1; with inexact masses it can
    only be a summation-order flip) is demoted to a stall.

    The in-bin CP polish (``polish=True``): the pass also returns per-slot
    sums ``Σ (w·)x``, and the Kelley intersection of the objective's support
    lines at the straddling bin's two edges collapses to the bin's mass
    centroid ``Σ_bin w·x / Σ_bin w``.  The loop carries that cut (seeded
    from the analytic extreme cuts before sweep 1, :func:`_seed_cut`) and
    hands it to :func:`polish_edges`, so the next sweep has near-ulp
    resolution around the minimizer.  The cut steers only edge placement.

    ``prior`` (warm start): sweep 1's edges come from :func:`prior_edges`
    instead — the prior's realized bracket ends verbatim and the
    ``(prev_float(value), value)`` pair, so an unchanged answer
    collapse-certifies in one sweep; the prior's cut also seeds the carried
    cut (over the analytic polish seed) where it is finite and strictly
    inside the bracket.  Placement only, as the polish cut.

    ``found0`` / ``t0`` as in :func:`bracket_loop_batched`.  Returns
    ``(BatchState, xmin, xmax)``; ``iters`` counts histogram sweeps.
    """
    s, xmin, xmax, kk, dtype, xmean = _seed_state(ev, found0, t0)
    # Brackets narrow to realized edge values and the finalize recounts
    # against exactly those values, so the loop state must not round edges
    # through a storage dtype below the kernels' f32 (bf16 data would
    # otherwise round yL up and break the count invariant).
    dt = torch.promote_types(dtype, torch.float32)
    s = s._replace(yL=s.yL.to(dt), yR=s.yR.to(dt),
                   t_exact=s.t_exact.to(dt), tp=s.tp.to(dt))
    if polish:
        # seed the carried cut with the analytic CP intersection, so that
        # even sweep 1 puts half its bins near the expected minimizer
        cut0 = _seed_cut(ev, kk, xmin, xmax, xmean)
        bad = ~torch.isfinite(cut0) | (cut0 <= s.yL) | (cut0 >= s.yR)
        s = s._replace(tp=torch.where(bad, 0.5 * (s.yL + s.yR),
                                      cut0).to(dt))
    pb = None
    if prior is not None:
        pb = _prior_to(prior, dt, s.yL)
        # the prior's carried cut beats the analytic seed where usable
        okc = torch.isfinite(pb.cut) & (pb.cut > s.yL) & (pb.cut < s.yR)
        s = s._replace(tp=torch.where(okc, pb.cut, s.tp))
    stalled = torch.zeros_like(s.found_exact)
    while s.it < maxit:
        lv = _live(s, cap) & ~stalled
        if not bool(lv.any()):
            break
        # the realized edges are computed ONCE here and shared by the data
        # pass and the narrowing decision (the exactness contract); a warm
        # sweep 1 places them from the prior
        if pb is not None and s.it == 0:
            edges = prior_edges(s.yL, s.yR, pb, nbins)
        elif polish:
            edges = polish_edges(s.yL, s.yR, s.tp, nbins)
        else:
            edges = bin_edges(s.yL, s.yR, nbins)
        # sweep 1's bracket is [min, max]: every element lies inside it
        cnt, mass, msum = ev.histogram(edges, need_msum=polish,
                                       full_bracket=s.it == 0)
        # prefix counts at the realized edges: cum[..., j] = count(x <= e_j)
        cumn = torch.cumsum(cnt[..., :-1], dim=-1, dtype=torch.int32)
        # the prefix measures decide the narrowing (the counts themselves on
        # the counting leg)
        cum = cumn if mass is cnt else torch.cumsum(mass[..., :-1], dim=-1)
        yLn, yRn, _, _, jm1, jstar, hit_lo, exact, stall = \
            binned_descent_step(cum, edges, s.yL, s.yR, kk)
        cLn, cRn = _take(cumn, jm1), _take(cumn, jstar)
        late_hit_lo = hit_lo & (s.it > 0)
        exact = lv & exact & ~late_hit_lo
        t_ex = torch.where(hit_lo, s.yL, yRn)
        stall_n = lv & (stall | late_hit_lo)
        upd = lv & ~exact & ~stall_n
        tp = s.tp
        if polish:
            if msum is None:
                raise ValueError("binned polish needs the per-slot sums; "
                                 "this evaluator's histogram returned none")
            # the in-bin support-line intersection == the straddling bin's
            # mass centroid; guard empty bins and non-finite sums
            mbin = _take(mass, jstar).to(msum.dtype)
            sbin = _take(msum, jstar)
            tcut = sbin / torch.where(mbin > 0, mbin, 1)
            good = (mbin > 0) & torch.isfinite(tcut)
            tcut = torch.where(good, _clip(tcut, yLn, yRn),
                               0.5 * (yLn + yRn)).to(dt)
            tp = torch.where(upd, tcut, s.tp)
        s = s._replace(
            yL=torch.where(upd, yLn, s.yL),
            yR=torch.where(upd, yRn, s.yR),
            cleL=torch.where(upd, cLn, s.cleL),
            cleR=torch.where(upd, cRn, s.cleR),
            t_exact=torch.where(exact, t_ex, s.t_exact),
            found_exact=s.found_exact | exact,
            iters=s.iters + lv.to(torch.int32),
            it=s.it + 1,
            tp=tp,
        )
        stalled = stalled | stall_n
    return s, xmin, xmax


def _run_bracket_phase(ev, method, maxit, cap, nbins, prior=None):
    """Dispatch the phase-1 loop for a resolved method; ``prior`` places
    the first sweep's edges or the first cp pivot."""
    if method in ("binned", "binned_polish"):
        return binned_loop_batched(ev, nbins=nbins, maxit=maxit, cap=cap,
                                   polish=method == "binned_polish",
                                   prior=prior)
    return bracket_loop_batched(ev, method=method, maxit=maxit, cap=cap,
                                prior=prior)


def rank_compact(mask_in: torch.Tensor, cap: int, cols):
    """First-``cap`` survivors of each row of a (B, n) mask by RANK GATHER.

    The paper's ``copy_if`` as a static-shape gather: ``pos`` is each
    element's inclusive survivor rank (an int32 cumsum of the mask), so the
    i-th survivor's index is ``searchsorted(pos, i)``.  ``cols`` is a
    sequence of ``(values, pad)`` pairs gathered at the same survivor
    indices (aligned buffers, ``pad`` past the last survivor).  Returns the
    list of ``(B, cap)`` buffers and the survivor counts ``n_in``.
    """
    b, n = mask_in.shape
    n_in = torch.sum(mask_in, dim=1, dtype=torch.int32)
    pos = torch.cumsum(mask_in, dim=1, dtype=torch.int32)
    want = torch.arange(1, cap + 1, dtype=torch.int32, device=mask_in.device)
    idx = torch.searchsorted(pos, want.expand(b, cap).contiguous(),
                             side="left").clamp(max=n - 1)
    have = want[None, :] <= n_in[:, None]
    return [torch.where(have, torch.gather(v, 1, idx), pad)
            for v, pad in cols], n_in


def _compact_interval(x, yL, yR, cap, w=None):
    """Phase-2 survivor compaction + fallback probes, row-wise.

    The open pivot interval ``(yL, yR]`` of each row lands in a (B, cap)
    buffer via :func:`rank_compact` (first ``cap`` survivors in data order,
    +inf pad), next to the measures the answer assembly needs: ``cLm =
    measure(x <= yL)``, the in-bracket count, the next distinct value above
    ``yL`` and its inclusive measure (tie fallback verification).  The
    brackets are (B, 1) columns, so bf16 data is compared in f32.

    ``w=None`` is the counting leg: the measures are int32 counts and the
    weight buffer comes back ``None``.  With weights ``w`` (B, n), the
    (value, weight) pairs land in aligned buffers (pad weights 0, so the
    sorted prefix masses are unaffected) and the measures are masses in
    ``w``'s dtype.
    """
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    lo, hi = yL[:, None], yR[:, None]
    mask_in = (x > lo) & (x <= hi)
    vnext = torch.amin(torch.where(x > lo, x, big), dim=1)
    if w is None:
        cL = torch.sum(x <= lo, dim=1, dtype=torch.int32)
        (z,), n_in = rank_compact(mask_in, cap, [(x, big)])
        m_le_v = torch.sum(x <= vnext[:, None], dim=1, dtype=torch.int32)
        return z, None, cL, n_in, vnext, m_le_v
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    (z, zw), n_in = rank_compact(mask_in, cap, [(x, big), (w, zero)])
    # each row's masses alone: their bits do not follow the batch
    cLw = ops.row_sums(x, w, yL, "le", dtype=w.dtype)
    w_le_v = ops.row_sums(x, w, vnext, "le", dtype=w.dtype)
    return z, zw, cLw, n_in, vnext, w_le_v


def _assemble_answers(kk, s: BatchState, cap, zs, zws, cLm, n_in, vnext,
                      m_le_v, m_lt_max, xmin, xmax) -> SelectResult:
    """Per-row answer/status cascade from the sorted ``(B, cap)`` buffer
    ``zs`` (its aligned weights ``zws``, ``None`` on the counting leg) and
    the measures.

    Counting leg: the in-buffer answer is direct indexing at ``k - cL - 1``
    and the extreme shortcuts fire off the exact integer counts.  Weighted
    leg: the answer is the first survivor whose cumulative mass (on top of
    the below-bracket mass ``cLm``) reaches ``k``; because these masses are
    re-measured by sums in another order than the loop's passes, the
    buffer certifies only when its mass actually reaches ``k``, and the
    extreme shortcuts are gated on the seed bracket (a rounding flip near
    ``k`` with the bracket off the extreme falls through to the sort /
    fallback chain — fail safe).
    """
    if zws is None:
        sort_idx = torch.clamp(kk - cLm - 1, 0, cap - 1)
        ans_sort = _take(zs, sort_idx)
        sort_ok = n_in <= cap
        at_min = cLm >= kk
        at_max = m_lt_max < kk
    else:
        reach = cLm[..., None] + torch.cumsum(zws, dim=-1) >= kk[..., None]
        # first True of each row (argmax on bool is not on every build)
        ans_sort = _take(zs, torch.argmax(reach.to(torch.int32), dim=-1))
        # the buffer certifies only when it holds every survivor AND its
        # mass reaches k (an all-False argmax must not certify)
        sort_ok = (n_in <= cap) & reach[..., -1]
        at_min = (cLm >= kk) & (s.yL == xmin)
        at_max = (m_lt_max < kk) & (s.yR == xmax)
    fallback_ok = (cLm < kk) & (kk <= m_le_v)

    value = torch.where(
        s.found_exact,
        s.t_exact,
        torch.where(sort_ok, ans_sort,
                    torch.where(fallback_ok, vnext, s.yR)),
    )
    status = torch.where(
        s.found_exact,
        EXACT_HIT,
        torch.where(
            sort_ok,
            HYBRID_SORT,
            torch.where(fallback_ok, TIE_FALLBACK, NOT_CONVERGED),
        ),
    )
    # Extreme shortcuts (the bracket invariant count(y_L) < k only holds for
    # answers strictly inside the data range): if count(x <= y_L) >= k the
    # answer is at or below y_L, which can only be the minimum.  Symmetric
    # test at the max.  Also covers k==1, k==n and all-equal rows.
    value = torch.where(at_min, xmin, torch.where(at_max, xmax, value))
    status = torch.where(at_min | at_max, EXACT_HIT, status)
    return SelectResult(
        value=value, iters=s.iters, status=status.to(torch.int32),
        y_lo=s.yL, y_hi=s.yR, n_in=n_in,
    )


def _sort_buffers(z, zw):
    """Sort the compacted values; on the weighted leg carry the aligned
    weights through the same permutation."""
    if zw is None:
        return torch.sort(z, dim=-1).values, None
    zs, order = torch.sort(z, dim=-1, stable=True)
    return zs, torch.gather(zw, -1, order)


def _finalize_rows(x, kk, s: BatchState, cap, xmin, xmax,
                   w=None) -> SelectResult:
    """Exact per-row recovery from the final brackets.

    Pass 1 (the paper's ``copy_if`` + count, row-wise): compact each row's
    open pivot interval into a (B, cap) buffer (value, weight pairs with
    weights ``w``), measure ``x <= y_L`` and find the next distinct value
    above ``y_L``; one batched sort of the buffer.  Pass 2 (tie fallback
    verification): ``measure(x <= vnext)`` per row.
    """
    z, zw, cLm, n_in, vnext, m_le_v = _compact_interval(x, s.yL, s.yR, cap,
                                                        w)
    zs, zws = _sort_buffers(z, zw)
    if w is None:
        m_lt_max = torch.sum(x < xmax[:, None], dim=1, dtype=torch.int32)
    else:
        m_lt_max = ops.row_sums(x, w, xmax, "lt", dtype=w.dtype)
    return _assemble_answers(kk, s, cap, zs, zws, cLm, n_in, vnext, m_le_v,
                             m_lt_max, xmin, xmax)


def _finalize_shared(x, kk, s: BatchState, cap, xmin, xmax,
                     w=None) -> SelectResult:
    """Shared-x exact finalize on per-pivot compacted buffers.

    The compaction runs pivot by pivot against the ONE ``(n,)`` array (a
    ``(1, n)`` view through :func:`_compact_interval`, the (value, weight)
    pair with weights ``w``), so peak memory stays O(n + K*cap) and no
    ``(K, n)`` tensor exists.  ``xmin``/``xmax`` are (K,) broadcasts of the
    global extremes, so one shared pass gives every pivot's
    ``measure(x < max)``.
    """
    x = x.reshape(1, -1)
    if w is not None:
        w = w.reshape(1, -1)
    parts = [_compact_interval(x, s.yL[j:j + 1], s.yR[j:j + 1], cap, w)
             for j in range(kk.shape[0])]
    z, zw, cLm, n_in, vnext, m_le_v = (
        None if p[0] is None else torch.cat(p) for p in zip(*parts))
    zs, zws = _sort_buffers(z, zw)
    below_max = x < torch.amax(xmax)
    if w is None:
        m_lt_max = torch.sum(below_max, dtype=torch.int32)
    else:
        m_lt_max = torch.sum(torch.where(below_max, w, 0), dtype=w.dtype)
    return _assemble_answers(kk, s, cap, zs, zws, cLm, n_in, vnext, m_le_v,
                             m_lt_max.broadcast_to(kk.shape), xmin, xmax)


def _default_cap(n: int) -> int:
    # generous: >= 2 * sqrt-ish growth, bounded; paper observed |z| ~ 1-5% n.
    return int(min(max(4096, n // 64), 1 << 19))


def _default_cap_rows(n: int) -> int:
    # Batched regimes keep a (B, cap) compaction buffer, so the per-row cap
    # is tighter than the scalar default: a few more bracket iterations
    # (cheap fused passes, shared by the whole batch) buy a much smaller
    # batched sort.
    return int(min(max(256, n // 64), 4096))


def _log1p_prior(prior: Prior, x, x0) -> Prior:
    """The prior in the log1p domain of anchors ``x0`` (per row, or one):
    ``log1p(v - x0)`` per field, in ``x``'s dtype."""
    return Prior(*(torch.log1p(torch.as_tensor(f, device=x.device).to(
        x.dtype) - x0) for f in prior))


def _map_bracket_back_rows(x, xt, s: BatchState) -> BatchState:
    """Map a transformed-domain bracket back to original values, row-wise.

    F is monotone non-decreasing in fp on the data, so
        y_orig = max{x_i : F(x_i) <= y_t}
    preserves counts exactly: count(x <= y_orig) == count(F(x) <= y_t).
    Both loop invariants therefore transfer to the original domain.  On an
    exact hit the t-space image may merge several distinct originals (F is
    not injective in fp): collapse the bracket to the image's preimage set
    and drop the certificate — the original-space finalize re-resolves it.
    """
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    yL_t = torch.where(s.found_exact, s.t_exact, s.yL)[:, None]
    yR_t = torch.where(s.found_exact, s.t_exact, s.yR)[:, None]
    yL = torch.where(
        s.found_exact,
        torch.amax(torch.where(xt < yL_t, x, neg), dim=1),  # strict: preimage
        torch.amax(torch.where(xt <= yL_t, x, neg), dim=1),
    )
    yR = torch.amax(torch.where(xt <= yR_t, x, neg), dim=1)
    return s._replace(
        yL=yL, yR=yR,
        # exactness certificates do not survive the fp roundtrip:
        found_exact=torch.zeros_like(s.found_exact),
    )


def _map_bracket_back_shared(x, xt, s: BatchState) -> BatchState:
    """Shared-x analogue of :func:`_map_bracket_back_rows`: one ``(n,)``
    array, (K,) transformed brackets, mapped back by the same
    count-preserving preimage reductions pivot by pivot, so the ``(K, n)``
    broadcast never materializes."""
    neg = torch.tensor(float("-inf"), dtype=x.dtype, device=x.device)
    x, xt = x.reshape(-1), xt.reshape(-1)
    yL_t = torch.where(s.found_exact, s.t_exact, s.yL)
    yR_t = torch.where(s.found_exact, s.t_exact, s.yR)
    yL, yR = [], []
    for j in range(yL_t.shape[0]):
        # (1,)-shaped bounds, so bf16 data is compared in f32
        lo, hi = yL_t[j:j + 1], yR_t[j:j + 1]
        yL.append(torch.where(
            s.found_exact[j:j + 1],
            torch.amax(torch.where(xt < lo, x, neg)),  # strict: preimage
            torch.amax(torch.where(xt <= lo, x, neg))))
        yR.append(torch.amax(torch.where(xt <= hi, x, neg)).reshape(1))
    return s._replace(
        yL=torch.cat(yL), yR=torch.cat(yR),
        # exactness certificates do not survive the fp roundtrip:
        found_exact=torch.zeros_like(s.found_exact),
    )


def select_rows(
    x: torch.Tensor,
    k,
    *,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    transform: Optional[str] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """Rows-mode batched selection: ``x`` is (B, n), ``k`` scalar or (B,).

    Every field of the returned :class:`SelectResult` is (B,)-shaped; row
    ``i`` solves the independent problem ``x[i], k[i]``.  ``method=None``
    resolves to 'binned' for ``n >= BINNED_MIN_N`` and 'cp' otherwise;
    ``nbins`` sizes the binned sweeps (``None``: 128 where the kernel runs,
    16 on the plain path); ``transform='log1p'`` runs the iterations on the
    row-wise monotone image.  ``prior``: a warm start (:func:`as_prior`) —
    the result equals a cold solve's bit for bit, only the sweep or pass
    counts change; an unchanged answer re-certifies in one sweep or pass.
    Computes on ``x``'s device.
    """
    prior = as_prior(prior)
    if x.dim() != 2:
        raise ValueError(f"select_rows wants (B, n) data, got "
                         f"{tuple(x.shape)}")
    b, n = x.shape
    method = _resolve_method(method, n)
    nbins = _resolve_nbins(nbins, x)
    if cap is None:
        cap = _default_cap_rows(n)
    cap = min(cap, n)
    ks = torch.clamp(torch.as_tensor(k, device=x.device), 1, n).to(
        torch.int32).broadcast_to((b,))

    if method == "sort":
        xs = torch.sort(x, dim=1).values
        return SelectResult(
            value=_take(xs, ks - 1),
            iters=torch.zeros((b,), dtype=torch.int32, device=x.device),
            status=torch.full((b,), EXACT_HIT, dtype=torch.int32,
                              device=x.device),
            y_lo=xs[:, 0], y_hi=xs[:, -1],
            n_in=torch.full((b,), n, dtype=torch.int32, device=x.device),
        )

    if transform == "log1p":
        xt = transforms.log1p_transform_rows(x)
        if prior is not None:
            # map the (original-space) prior through the row anchors; a
            # value below the anchor maps to NaN and is sanitized away
            prior = _log1p_prior(prior, x, torch.amin(x, dim=1))
        s, _, _ = _run_bracket_phase(RowsEvaluator(xt, ks), method, maxit,
                                     cap, nbins, prior)
        s = _map_bracket_back_rows(x, xt, s)
        return _finalize_rows(x, ks, s, cap, torch.amin(x, dim=1),
                              torch.amax(x, dim=1))
    if transform is not None:
        raise ValueError(f"unknown transform {transform!r}")

    ev = RowsEvaluator(x, ks)
    s, xmin, xmax = _run_bracket_phase(ev, method, maxit, cap, nbins, prior)
    return _finalize_rows(x, ks, s, cap, xmin, xmax)


def order_statistic(
    x: torch.Tensor,
    k,
    *,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    transform: Optional[str] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """k-th smallest element of ``x`` (k is 1-indexed): the ``B = 1`` view
    of :func:`select_rows` with the scalar cap policy (one generous
    buffer).  ``cp`` and ``cp_hybrid`` are aliases."""
    x = x.reshape(-1)
    if cap is None:
        cap = _default_cap(x.numel())
    res = select_rows(
        x[None, :], torch.as_tensor(k, device=x.device).reshape(1),
        method=method, maxit=maxit, cap=cap, transform=transform,
        nbins=nbins, prior=as_prior(prior),
    )
    return SelectResult(*(a[0] for a in res))


def median(x: torch.Tensor, **kw) -> SelectResult:
    """Med(x) = x_([(n+1)/2]) (paper Sec. I convention)."""
    return order_statistic(x, (x.numel() + 1) // 2, **kw)


def ranks_from_quantiles(qs, n: int) -> torch.Tensor:
    """Target ranks ``ceil(q * n)`` clipped to ``[1, n]``, resolved on the
    host in f64, where every rank below 2^53 is exact (an f32 product is 4
    ulps of an integer wide at n ~ 2^25 and can land on the wrong rank).
    Returns int32 ranks on the CPU."""
    if isinstance(qs, torch.Tensor):
        qs = qs.detach().cpu().numpy()
    qv = np.asarray(qs, np.float64)
    return torch.as_tensor(
        np.asarray(np.clip(np.ceil(qv * float(n)), 1, n), np.int32))


def quantile(x: torch.Tensor, q, **kw) -> SelectResult:
    """Lower empirical q-quantile: x_(ceil(q*n)) clipped to [1, n]."""
    return order_statistic(x, ranks_from_quantiles(q, x.numel()), **kw)


def topk_threshold(x: torch.Tensor, m, **kw) -> SelectResult:
    """Value of the m-th largest element (for kNN / trimming)."""
    m = torch.as_tensor(m, device=x.device).to(torch.int32)
    return order_statistic(x, x.numel() - m + 1, **kw)


def multi_order_statistic(
    x: torch.Tensor,
    ks,
    *,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    transform: Optional[str] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """Several order statistics of the SAME array at once (shared-x mode).

    All K brackets iterate together against a :class:`SharedEvaluator`:
    each sweep or cp pass reads ``x`` ONCE for every live target (kernels
    K3 and K4 on the card), and the finalize compacts each target's
    survivors straight from the ``(n,)`` array (:func:`_finalize_shared`),
    so no ``(K, n)`` tensor exists.  Every field of the result is
    (K,)-shaped, in the order of ``ks``.  Options as :func:`select_rows`,
    with the batched cap policy; ``prior`` warm-starts every target from a
    previous (K,) result.
    """
    prior = as_prior(prior)
    x = x.reshape(-1)
    n = x.numel()
    method = _resolve_method(method, n)
    nbins = _resolve_nbins(nbins, x)
    ks = torch.clamp(torch.as_tensor(ks, device=x.device).reshape(-1), 1,
                     n).to(torch.int32)
    nk = ks.shape[0]
    if cap is None:
        cap = _default_cap_rows(n)
    cap = min(cap, n)

    if method == "sort":
        xs = torch.sort(x).values
        return SelectResult(
            value=xs[ks.to(torch.int64) - 1],
            iters=torch.zeros((nk,), dtype=torch.int32, device=x.device),
            status=torch.full((nk,), EXACT_HIT, dtype=torch.int32,
                              device=x.device),
            y_lo=xs[0].broadcast_to((nk,)), y_hi=xs[-1].broadcast_to((nk,)),
            n_in=torch.full((nk,), n, dtype=torch.int32, device=x.device),
        )

    if transform == "log1p":
        xt, _ = transforms.log1p_transform(x)
        if prior is not None:
            prior = _log1p_prior(prior, x, torch.amin(x))
        s, _, _ = _run_bracket_phase(SharedEvaluator(xt, ks), method, maxit,
                                     cap, nbins, prior)
        s = _map_bracket_back_shared(x, xt, s)
        return _finalize_shared(x, ks, s, cap,
                                torch.amin(x).broadcast_to((nk,)),
                                torch.amax(x).broadcast_to((nk,)))
    if transform is not None:
        raise ValueError(f"unknown transform {transform!r}")

    ev = SharedEvaluator(x, ks)
    s, xmin, xmax = _run_bracket_phase(ev, method, maxit, cap, nbins, prior)
    return _finalize_shared(ev.x, ks, s, cap, xmin, xmax)


def quantiles(x: torch.Tensor, qs, **kw) -> SelectResult:
    """Lower empirical quantiles at each q in ``qs`` from ONE shared-x
    solve: the K brackets narrow together from one data pass per round,
    so a decile vector costs the data traffic of a single median, not ~K
    times it."""
    return multi_order_statistic(x, ranks_from_quantiles(qs, x.numel()), **kw)


# ---------------------------------------------------------------------------
# Segmented selection: per-segment order statistics of ONE concatenated
# array (the per-leaf regime: gradient-clip thresholds over a pytree)
# ---------------------------------------------------------------------------


def _finalize_segmented(x, seg, plan: GroupPlan, kk, s: BatchState, cap,
                        xmin, xmax) -> SelectResult:
    """Per-segment exact finalize on the segment-sorted layout (``x`` and
    ``seg`` sorted by segment, data order kept inside each; ``plan`` groups
    the segments): :func:`_finalize_rows`' compaction and probes with each
    element held against its own segment's bracket, in O(n) elementwise
    passes for all K segments — no ``(K, n)`` tensor and no per-segment
    pass.  A segment's survivors are its first ``cap`` elements in
    ``(y_lo, y_hi]`` in data order (its rank among them from an int64
    cumsum), as the reference's per-segment ``rank_compact`` gives them, so
    every field matches it."""
    nsegs = kk.shape[0]
    lo, hi = s.yL[seg], s.yR[seg]
    big = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    above = x > lo
    mask_in = above & (x <= hi)
    cL = plan.tally(~above)
    vnext = plan.reduce(torch.where(above, x, big), "min")
    # each survivor's rank in its segment: an int64 cumsum of the mask
    # less the survivors before the segment's first element (segments are
    # non-empty, so its start is a valid position)
    crank = torch.cumsum(mask_in, 0, dtype=torch.int64)
    first = torch.clamp(plan.start, max=x.numel() - 1)
    before = crank[first] - mask_in[first].to(torch.int64)
    n_in = (crank[torch.clamp(plan.start + plan.size - 1, min=0)]
            - before).to(torch.int32)
    rank = crank - before[seg]
    keep = torch.nonzero(mask_in & (rank <= cap)).reshape(-1)
    z = torch.full((nsegs * cap,), float("inf"), dtype=x.dtype,
                   device=x.device)
    z[seg[keep].to(torch.int64) * cap + rank[keep] - 1] = x[keep]
    zs = torch.sort(z.view(nsegs, cap), dim=1).values
    m_le_v = plan.tally(x <= vnext[seg])
    m_lt_max = plan.tally(x < xmax[seg])
    return _assemble_answers(kk, s, cap, zs, None, cL, n_in, vnext, m_le_v,
                             m_lt_max, xmin, xmax)


def segmented_order_statistic(
    x: torch.Tensor,
    seg,
    ks,
    *,
    nsegs: int,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """Per-segment order statistics of one concatenated array.

    ``x`` (n,) holds K = ``nsegs`` segments' data, interleaved or
    concatenated; ``seg`` (n,) gives each element's segment id in
    ``[0, nsegs)`` and ``ks`` (nsegs,) the 1-indexed target rank WITHIN each
    segment (clipped to the segment's size).  Every segment must be
    non-empty.  Returns a :class:`SelectResult` with (nsegs,) fields:
    segment ``i`` solves ``x[seg == i], ks[i]`` with the engine's
    exactness guarantees, and its result does not depend on the other
    segments.

    The engine runs on an :class:`~repro_torch.core.objective.FnEvaluator`
    over a segment-sorted layout, made once at entry by one stable sort of
    the positions by ``seg`` (data order kept inside a segment; skipped
    when ``seg`` is already sorted, as for concatenated pytree leaves).
    Every data pass is shared by all segments: the binned sweep is
    ``kernels.ref.segmented_histogram_ref`` (each element binned against
    its own segment's ladder; integer counts), the cp pass and the stats
    reduce each segment with a :class:`~repro_torch.kernels.ref.GroupPlan`
    (a fixed tree over its own elements: no f32 atomics, no dependence on
    the other segments), and the finalize is O(n)
    (:func:`_finalize_segmented`).  It is plain torch, on ``x``'s device,
    and launches none of the port's kernels.  ``method``, ``maxit``,
    ``cap``, ``nbins`` (128 where the kernels would run, else 16) and
    ``prior`` as in :func:`multi_order_statistic`.
    """
    prior = as_prior(prior)
    x = x.reshape(-1)
    n = x.numel()
    seg = torch.as_tensor(seg, device=x.device).reshape(-1)
    method = _resolve_method(method, n)
    nbins = _resolve_nbins(nbins, x)
    if cap is None:
        cap = _default_cap_rows(n)
    cap = min(cap, n)
    x, seg, plan = _segmented_layout(x, seg, nsegs)
    counts = plan.size.to(torch.int32)
    kk = torch.minimum(
        torch.clamp(torch.as_tensor(ks, device=x.device).reshape(-1).to(
            torch.int32), min=1), torch.clamp(counts, min=1))

    if method == "sort":
        # the segment-sorted layout sorted by value inside each segment:
        # a stable sort by value, then a stable sort by segment
        xs, vo = torch.sort(x, stable=True)
        xs = xs[torch.sort(seg[vo], stable=True).indices]
        return SelectResult(
            value=xs[torch.clamp(plan.start + kk - 1, 0, n - 1)],
            iters=torch.zeros((nsegs,), dtype=torch.int32, device=x.device),
            status=torch.full((nsegs,), EXACT_HIT, dtype=torch.int32,
                              device=x.device),
            y_lo=plan.reduce(x, "min"), y_hi=plan.reduce(x, "max"),
            n_in=counts)

    ev = _segmented_evaluator(x, seg, plan, counts, kk)
    s, xmin, xmax = _run_bracket_phase(ev, method, maxit, cap, nbins, prior)
    return _finalize_segmented(x, seg, plan, kk, s, cap, xmin, xmax)


def _segmented_layout(x, seg, nsegs: int):
    """The segment-sorted layout ``(x, seg, plan)``: ``x`` and ``seg``
    stably sorted by segment (data order kept inside each; no sort when
    ``seg`` is already nondecreasing), ``seg`` as int32, and the
    :class:`GroupPlan` of the segments."""
    if not bool((seg[1:] >= seg[:-1]).all()):
        seg, order = torch.sort(seg, stable=True)
        x = x[order]
    seg = seg.to(torch.int32)
    return x, seg, GroupPlan(seg, nsegs)


def _segmented_evaluator(x, seg, plan: GroupPlan, counts,
                         kk) -> FnEvaluator:
    """The counting-leg :class:`FnEvaluator` of segmented selection over
    the segment-sorted layout: each segment's sums (the cp partials, the
    mean) and extremes by ``plan`` (a fixed tree over its own elements),
    its counts by integer cumsums (``GroupPlan.tally``), its binned sweep
    by ``segmented_histogram_ref``."""
    acc = _accum_dtype(x)

    def partials(y):
        d = x.to(acc) - y.to(acc)[seg]
        zero = torch.zeros((), dtype=acc, device=x.device)
        sums = plan.reduce(torch.stack(
            [torch.maximum(d, zero), torch.maximum(-d, zero)], dim=-1))
        return sums[:, 0], sums[:, 1], plan.tally(d < 0), plan.tally(d <= 0)

    def init_stats():
        mean = plan.reduce(x.to(acc)) / torch.clamp(counts, min=1).to(acc)
        return (plan.reduce(x, "min"), plan.reduce(x, "max"),
                mean.to(x.dtype))

    def histogram(edges, need_msum=False):
        out = segmented_histogram_ref(x, seg, edges,
                                      rows=(x,) if need_msum else ())
        return out[0], out[0], (out[1] if need_msum else None)

    return FnEvaluator(partials, counts, kk, init_stats, histogram=histogram)


def segmented_quantiles(x: torch.Tensor, seg, q, sizes,
                        **kw) -> SelectResult:
    """Per-segment lower q-quantiles from the STATIC segment sizes.

    ``sizes`` (a sequence of ints, the leaf sizes of the per-leaf regime)
    turns ``q`` into per-segment ranks ``ceil(q * size)`` clipped to
    ``[1, size]`` on the host in f64, then runs ONE
    :func:`segmented_order_statistic`.  ``q`` is a scalar (the same
    quantile in every segment) or one value per segment."""
    sizes = [int(v) for v in np.asarray(sizes).reshape(-1)]
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    qv = np.broadcast_to(np.asarray(q, np.float64).reshape(-1),
                         (len(sizes),))
    ks = np.asarray([int(np.clip(np.ceil(qi * ni), 1, max(ni, 1)))
                     for qi, ni in zip(qv, sizes)], np.int32)
    return segmented_order_statistic(x, seg, torch.as_tensor(ks),
                                     nsegs=len(sizes), **kw)


# ---------------------------------------------------------------------------
# Weighted order statistics: the same loops and finalize on an evaluator
# whose measure is the weight mass (uniform weights with wk = k reproduce
# the counting answers bit for bit)
# ---------------------------------------------------------------------------


def _weighted_sort_cumsum(xs, cumw, wkk):
    """Answer of the full-sort baseline: the first sorted value whose
    cumulative mass reaches the target; the maximum where nothing reaches
    it (the target exceeds the measured total: the limit of the
    definition)."""
    reach = cumw >= wkk[..., None]
    idx = torch.argmax(reach.to(torch.int32), dim=-1)
    return torch.where(reach[..., -1], _take(xs, idx), xs[..., -1])


def weighted_select_rows(
    x: torch.Tensor,
    w,
    wk,
    *,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """Rows-mode weighted selection: ``x``/``w`` (B, n), ``wk`` scalar or
    (B,) target cumulative weights.

    Row ``i`` returns the smallest element ``v`` of ``x[i]`` with
    ``sum(w[i, x[i] <= v]) >= wk[i]`` (``wk`` clipped to the row's total
    mass).  Weights must be non-negative; uniform weights with ``wk = k``
    reproduce :func:`select_rows` exactly.  Options as :func:`select_rows`
    without ``transform``; ``method='sort'`` is the weighted sort-cumsum
    baseline.  ``nbins=None`` resolves on both operands (an f64 ``w`` on
    f32 ``x`` takes the plain version and its 16 bins).  Computes on
    ``x``'s device; ``w`` is moved there.  ``prior`` as in
    :func:`select_rows`.
    """
    if x.dim() != 2:
        raise ValueError(f"weighted_select_rows wants (B, n) data, got "
                         f"{tuple(x.shape)}")
    b, n = x.shape
    w = torch.as_tensor(w, device=x.device).broadcast_to(x.shape)
    method = _resolve_method(method, n)
    nbins = _resolve_nbins(nbins, x, w)
    if cap is None:
        cap = _default_cap_rows(n)
    cap = min(cap, n)
    ev = RowsEvaluator(x, wk, weights=w)
    wkk = ev.k  # clipped target masses, accumulation dtype, (B,)

    if method == "sort":
        xs, order = torch.sort(x, dim=1, stable=True)
        ws = torch.gather(w.to(wkk.dtype), 1, order)
        return SelectResult(
            value=_weighted_sort_cumsum(xs, torch.cumsum(ws, dim=1), wkk),
            iters=torch.zeros((b,), dtype=torch.int32, device=x.device),
            status=torch.full((b,), EXACT_HIT, dtype=torch.int32,
                              device=x.device),
            y_lo=xs[:, 0], y_hi=xs[:, -1],
            n_in=torch.full((b,), n, dtype=torch.int32, device=x.device),
        )

    s, xmin, xmax = _run_bracket_phase(ev, method, maxit, cap, nbins,
                                       as_prior(prior))
    return _finalize_rows(ev.x, wkk, s, cap, xmin, xmax,
                          w=ev.w.to(wkk.dtype))


def weighted_order_statistic(
    x: torch.Tensor,
    w,
    wk,
    *,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """Smallest element of ``x`` whose cumulative weight reaches ``wk``:
    the ``B = 1`` view of :func:`weighted_select_rows` with the scalar cap
    policy.  With ``w = ones`` and ``wk = k`` this is exactly
    :func:`order_statistic`."""
    x = x.reshape(-1)
    if cap is None:
        cap = _default_cap(x.numel())
    res = weighted_select_rows(
        x[None, :], torch.as_tensor(w, device=x.device).reshape(1, -1),
        torch.as_tensor(wk, device=x.device).reshape(1),
        method=method, maxit=maxit, cap=cap, nbins=nbins,
        prior=as_prior(prior),
    )
    return SelectResult(*(a[0] for a in res))


def _total_mass(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Total weight in the mass accumulation dtype (the ``wk``/``W``
    reference)."""
    return torch.sum(w, dtype=_weight_accum_dtype(x, w))


def weighted_median(x: torch.Tensor, w, **kw) -> SelectResult:
    """Lower weighted median: smallest v with ``mass(x <= v) >= W/2``.
    Uniform weights reproduce :func:`median` (= x_([(n+1)/2])) exactly."""
    w = torch.as_tensor(w, device=x.device).reshape(-1)
    return weighted_order_statistic(x, w, 0.5 * _total_mass(x, w), **kw)


def weighted_quantile(x: torch.Tensor, w, q, **kw) -> SelectResult:
    """Lower weighted q-quantile: smallest v with ``mass(x <= v) >= q*W``."""
    w = torch.as_tensor(w, device=x.device).reshape(-1)
    W = _total_mass(x, w)
    return weighted_order_statistic(
        x, w, torch.as_tensor(q, dtype=W.dtype, device=x.device) * W, **kw)


def weighted_multi_order_statistic(
    x: torch.Tensor,
    w,
    wks,
    *,
    method: Optional[str] = None,
    maxit: int = 64,
    cap: Optional[int] = None,
    nbins: Optional[int] = None,
    prior=None,
) -> SelectResult:
    """Several weighted order statistics of the SAME array at once.

    Shared-x mode, as :func:`multi_order_statistic`: all K target masses
    ``wks`` iterate together against a weighted :class:`SharedEvaluator`
    (kernels K3w and K4w on the card read ``x`` and ``w`` once per sweep or
    pass for all K), and the finalize compacts each target's (value,
    weight) survivors from the ``(n,)`` arrays.  Every field of the result
    is (K,)-shaped.  Options as :func:`weighted_select_rows`, with the
    batched cap policy.
    """
    x = x.reshape(-1)
    n = x.numel()
    w = torch.as_tensor(w, device=x.device).reshape(-1).broadcast_to(x.shape)
    method = _resolve_method(method, n)
    nbins = _resolve_nbins(nbins, x, w)
    if cap is None:
        cap = _default_cap_rows(n)
    cap = min(cap, n)
    ev = SharedEvaluator(x, wks, weights=w)
    wkk = ev.k
    nk = wkk.shape[0]

    if method == "sort":
        xs, order = torch.sort(x, stable=True)
        cumw = torch.cumsum(w.to(wkk.dtype)[order], dim=0)
        # the first sorted value whose cumulative mass reaches each target
        # (the maximum where none does), without a (K, n) comparison
        idx = torch.searchsorted(cumw, wkk).clamp(max=n - 1)
        return SelectResult(
            value=xs[idx],
            iters=torch.zeros((nk,), dtype=torch.int32, device=x.device),
            status=torch.full((nk,), EXACT_HIT, dtype=torch.int32,
                              device=x.device),
            y_lo=xs[0].broadcast_to((nk,)), y_hi=xs[-1].broadcast_to((nk,)),
            n_in=torch.full((nk,), n, dtype=torch.int32, device=x.device),
        )

    s, xmin, xmax = _run_bracket_phase(ev, method, maxit, cap, nbins,
                                       as_prior(prior))
    return _finalize_shared(ev.x, wkk, s, cap, xmin, xmax,
                            w=ev.w.to(wkk.dtype))


def weighted_quantiles(x: torch.Tensor, w, qs, **kw) -> SelectResult:
    """Lower weighted quantiles at each q in ``qs`` from one shared-x
    solve.  The target masses ``q * W`` are formed on the host in f64 and
    rounded once into the accumulation dtype (the rationale of
    :func:`ranks_from_quantiles`)."""
    x = x.reshape(-1)
    w = torch.as_tensor(w, device=x.device).reshape(-1)
    W = _total_mass(x, w)
    if isinstance(qs, torch.Tensor):
        qs = qs.detach().cpu().numpy()
    wks = torch.as_tensor(np.asarray(qs, np.float64).reshape(-1) * float(W),
                          dtype=W.dtype, device=x.device)
    return weighted_multi_order_statistic(x, w, wks, **kw)
