"""Plain PyTorch versions of the kernels (the correctness references).

Each function here computes what one CUDA kernel of
:mod:`repro_torch.kernels.cp_objective` computes, in plain tensor ops on
any device.  The CPU path of the port runs on them; on the card only
``chip_smoke.py`` calls them, to hold each kernel against its plain
version.  ``bin_edges`` is the engine's single source of realized edges.
"""
from __future__ import annotations

import torch


def _accum_dtype(x: torch.Tensor) -> torch.dtype:
    # The kernels accumulate in f32, so low-precision inputs (bf16) are
    # promoted to f32 for bit-comparable partials — but NEVER downcast:
    # f64 selection must keep full precision or the count certificates lie
    # about exactness.
    return torch.promote_types(x.dtype, torch.float32)


def cp_partials_ref(x: torch.Tensor, y):
    """Plain version of one row of ``cp_partials_batched``: ``(sum_pos,
    sum_neg, n_lt, n_le)`` of ``d = x - y``.  ``max(d, 0)`` propagates NaN
    into the sums; the counts compare ``d`` (so ``inf - inf`` counts in
    neither)."""
    dt = _accum_dtype(x)
    x = x.reshape(-1).to(dt)
    y = torch.as_tensor(y, dtype=dt, device=x.device)
    return _partials(x - y, dim=-1)


def cp_partials_batched_ref(x: torch.Tensor, y):
    """Plain version of ``cp_partials_batched``: ``x`` (B, n), pivots ``y``
    (B,); returns four (B,) tensors."""
    dt = _accum_dtype(x)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1, 1)
    return _partials(x.to(dt) - y, dim=-1)


def cp_partials_multi_ref(x: torch.Tensor, y):
    """Plain version of ``cp_partials_multi``: one shared ``x`` (n,) and
    pivots ``y`` (K,); returns four (K,) tensors.  One pivot at a time, so
    no ``(K, n)`` tensor exists."""
    dt = _accum_dtype(x)
    x = x.reshape(-1).to(dt)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1)
    parts = [_partials(x - yj, dim=-1) for yj in y]
    return tuple(torch.stack(p) for p in zip(*parts))


def _partials(d: torch.Tensor, dim: int):
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    sum_pos = torch.sum(torch.maximum(d, zero), dim=dim)
    sum_neg = torch.sum(torch.maximum(-d, zero), dim=dim)
    n_lt = torch.sum(d < 0, dim=dim, dtype=torch.int32)
    n_le = torch.sum(d <= 0, dim=dim, dtype=torch.int32)
    return sum_pos, sum_neg, n_lt, n_le


# ---------------------------------------------------------------------------
# Binned bracket descent: realized edges, slot assignment, histograms
# ---------------------------------------------------------------------------


def bin_edges(lo, hi, nbins: int) -> torch.Tensor:
    """Realized fp bin-edge values ``e_j = clip(lo + w*j, lo, hi)`` with
    ``w = clip(hi/nbins - lo/nbins, 0, finfo.max)`` and ``e_nbins`` forced
    to ``hi``, appended as a trailing axis of size ``nbins + 1``.

    SINGLE SOURCE OF TRUTH for edge construction: the engine builds the
    edges once per sweep here and the histogram pass only COMPARES against
    them, so its counts stay consistent with the engine's later
    ``x <= e_j`` narrowing and finalize comparisons.  Monotone
    non-decreasing in fp (``w >= 0``, clip preserves order).

    The arithmetic reproduces the reference's compiled edges bit for bit
    (the reference engine runs under ``jit``, and XLA:CPU rewrites it):
    ``/ nbins`` becomes a multiply by the f32 reciprocal ``c``, ``w`` is
    the fused ``fma(hi, c, -(lo*c))`` and ``e_j`` the fused
    ``fma(w, j, lo)``.  Each fused form is computed in f64, where the
    products of f32 operands are exact, and rounded once to f32.  f64
    brackets use the reciprocal form unfused.

    Overflow safety: ``w`` divides BEFORE differencing and is clamped
    finite (full-range ±3e38 brackets, ``nbins == 1``); ``lo + w*j`` is
    clipped into ``[lo, hi]``.
    """
    lo = torch.as_tensor(lo)
    hi = torch.as_tensor(hi, dtype=lo.dtype, device=lo.device)
    dt = lo.dtype
    wide = torch.float64
    c = torch.ones((), dtype=dt, device=lo.device) / nbins
    if dt == wide:
        w = hi * c - lo * c
    else:
        w = (hi.to(wide) * c.to(wide) - (lo * c).to(wide)).to(dt)
    w = torch.clamp(w, 0, torch.finfo(dt).max)
    j = torch.arange(nbins + 1, dtype=wide, device=lo.device)
    e = (lo.to(wide)[..., None] + w.to(wide)[..., None] * j).to(dt)
    lo1, hi1 = lo[..., None], hi[..., None]
    e = torch.minimum(torch.maximum(e, lo1), hi1)
    last = torch.arange(nbins + 1, device=lo.device) == nbins
    return torch.where(last, hi1, e)


def searchsorted_slots(x: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """THE slot oracle: ``slot = count(edges < x)`` by binary search.

    Slot layout (``nbins + 2`` slots): 0 = ``x <= e_0`` (including -inf);
    j in 1..nbins = ``e_{j-1} < x <= e_j``; nbins+1 = ``x > e_nbins`` and
    NaN (every NaN comparison is false, so a binary search walks right; the
    top slot is pinned explicitly).  ``x`` ``(..., n)`` and ``edges``
    ``(..., nbins+1)`` broadcast over leading dims; returns int32 slots
    shaped like the broadcast ``x``.
    """
    x = x.to(edges.dtype)
    if edges.dim() == 1:
        s = torch.searchsorted(edges.contiguous(), x.contiguous(),
                               side="left")
    else:
        lead = torch.broadcast_shapes(x.shape[:-1], edges.shape[:-1])
        xb = x.broadcast_to(lead + x.shape[-1:]).contiguous()
        eb = edges.broadcast_to(lead + edges.shape[-1:]).contiguous()
        s = torch.searchsorted(eb, xb, side="left")
    s = torch.where(torch.isnan(x), edges.shape[-1], s)
    return s.to(torch.int32)


def cp_histogram_batched_ref(x: torch.Tensor, edges: torch.Tensor, *,
                             want_sums: bool = True):
    """Plain version of ``cp_histogram_batched``: ``x`` (B, n), per-row
    realized edges ``(B, nbins+1)``.  Returns ``(cnt, bsum)`` of shape
    ``(B, nbins + 2)``: int32 counts per slot (layout in
    :func:`searchsorted_slots`) and, with ``want_sums``, the per-slot sums
    of ``x`` in the accumulate dtype (``None`` otherwise)."""
    dt = _accum_dtype(x)
    x = x.to(dt)
    edges = edges.to(dt)
    b = x.shape[0]
    nslots = edges.shape[-1] + 1
    slot = searchsorted_slots(x, edges).to(torch.int64)
    flat = (slot + torch.arange(b, device=x.device)[:, None] * nslots
            ).reshape(-1)
    cnt = torch.bincount(flat, minlength=b * nslots).reshape(b, nslots)
    bsum = None
    if want_sums:
        bsum = torch.zeros(b * nslots, dtype=dt, device=x.device).index_add_(
            0, flat, x.reshape(-1)).reshape(b, nslots)
    return cnt.to(torch.int32), bsum


def cp_histogram_ref(x: torch.Tensor, edges: torch.Tensor, *,
                     want_sums: bool = True):
    """Single-array view of :func:`cp_histogram_batched_ref`: ``x`` (n,),
    edges ``(nbins+1,)``; outputs ``(nbins + 2,)``."""
    cnt, bsum = cp_histogram_batched_ref(x.reshape(1, -1),
                                         edges.reshape(1, -1),
                                         want_sums=want_sums)
    return cnt[0], (bsum[0] if bsum is not None else None)


def cp_histogram_multi_ref(x: torch.Tensor, edges: torch.Tensor, *,
                           want_sums: bool = True):
    """Plain version of ``cp_histogram_multi``: one shared ``x`` (n,)
    binned against K realized ladders ``edges`` (K, nbins+1).  Returns
    ``(cnt, bsum)`` of shape ``(K, nbins + 2)``.  One ladder at a time
    (:func:`cp_histogram_ref`), so no ``(K, n)`` tensor exists."""
    cnt, bsum = zip(*(cp_histogram_ref(x, e, want_sums=want_sums)
                      for e in edges))
    return torch.stack(cnt), (torch.stack(bsum) if want_sums else None)


# ---------------------------------------------------------------------------
# Weighted leg: six weighted partials and the weighted histogram
# ---------------------------------------------------------------------------


def _waccum_dtype(x: torch.Tensor, w: torch.Tensor) -> torch.dtype:
    # Weighted accumulation promotes BOTH operands, with the kernels' f32
    # floor: f64 weights on f32 data accumulate mass in f64, so the
    # either-f64 path stays exact as the counting leg's f64 path does.
    return torch.promote_types(torch.promote_types(x.dtype, w.dtype),
                               torch.float32)


def _wpartials(d: torch.Tensor, w: torch.Tensor, dim: int):
    """``(wsum_pos, wsum_neg, w_lt, w_le, n_lt, n_le)`` of ``d = x - y``.
    ``where`` (not ``maximum``) as in the reference: an element whose
    ``d`` is NaN adds nothing to any sum and counts nowhere."""
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    lt, le = d < 0, d <= 0
    wsum_pos = torch.sum(torch.where(d > 0, w * d, zero), dim=dim)
    wsum_neg = torch.sum(torch.where(lt, -w * d, zero), dim=dim)
    w_lt = torch.sum(torch.where(lt, w, zero), dim=dim)
    w_le = torch.sum(torch.where(le, w, zero), dim=dim)
    n_lt = torch.sum(lt, dim=dim, dtype=torch.int32)
    n_le = torch.sum(le, dim=dim, dtype=torch.int32)
    return wsum_pos, wsum_neg, w_lt, w_le, n_lt, n_le


def wcp_partials_ref(x: torch.Tensor, w: torch.Tensor, y):
    """Plain version of ``wcp_partials``: the six weighted partials of
    ``x``/``w`` (n,) at the scalar pivot ``y`` — the weighted objective
    terms ``sum w*(x-y)+`` and ``sum w*(y-x)+``, the masses below and at or
    below the pivot, and the element counts (which drive the cap rule)."""
    dt = _waccum_dtype(x, w)
    x = x.reshape(-1).to(dt)
    w = w.reshape(-1).to(dt)
    y = torch.as_tensor(y, dtype=dt, device=x.device)
    return _wpartials(x - y, w, dim=-1)


def wcp_partials_batched_ref(x: torch.Tensor, w: torch.Tensor, y):
    """Plain version of ``wcp_partials_batched``: ``x``/``w`` (B, n),
    pivots ``y`` (B,); returns six (B,) tensors."""
    dt = _waccum_dtype(x, w)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1, 1)
    return _wpartials(x.to(dt) - y, w.to(dt), dim=-1)


def wcp_partials_multi_ref(x: torch.Tensor, w: torch.Tensor, y):
    """Plain version of ``wcp_partials_multi``: one shared ``x``/``w`` (n,)
    and pivots ``y`` (K,); returns six (K,) tensors.  One pivot at a time,
    so no ``(K, n)`` tensor exists."""
    dt = _waccum_dtype(x, w)
    x = x.reshape(-1).to(dt)
    w = w.reshape(-1).to(dt)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1)
    parts = [_wpartials(x - yj, w, dim=-1) for yj in y]
    return tuple(torch.stack(p) for p in zip(*parts))


def wcp_histogram_batched_ref(x: torch.Tensor, w: torch.Tensor,
                              edges: torch.Tensor, *, want_sums: bool = True):
    """Plain version of ``wcp_histogram_batched``: ``x``/``w`` (B, n),
    per-row realized edges ``(B, nbins+1)``.  Returns ``(cnt, wcnt, wsum)``
    of shape ``(B, nbins + 2)``: int32 counts per slot (layout in
    :func:`searchsorted_slots`), the per-slot weight mass — always, it is
    the weighted narrowing signal — and, with ``want_sums``, the per-slot
    ``sum(w*x)`` (``None`` otherwise), both in the accumulate dtype."""
    dt = _waccum_dtype(x, w)
    x, w, edges = x.to(dt), w.to(dt), edges.to(dt)
    b = x.shape[0]
    nslots = edges.shape[-1] + 1
    slot = searchsorted_slots(x, edges).to(torch.int64)
    flat = (slot + torch.arange(b, device=x.device)[:, None] * nslots
            ).reshape(-1)
    cnt = torch.bincount(flat, minlength=b * nslots).reshape(b, nslots)

    def per_slot(v):
        return torch.zeros(b * nslots, dtype=dt, device=x.device).index_add_(
            0, flat, v.reshape(-1)).reshape(b, nslots)

    return (cnt.to(torch.int32), per_slot(w),
            per_slot(w * x) if want_sums else None)


def wcp_histogram_ref(x: torch.Tensor, w: torch.Tensor, edges: torch.Tensor,
                      *, want_sums: bool = True):
    """Single-array view of :func:`wcp_histogram_batched_ref`: ``x``/``w``
    (n,), edges ``(nbins+1,)``; outputs ``(nbins + 2,)``."""
    out = wcp_histogram_batched_ref(x.reshape(1, -1), w.reshape(1, -1),
                                    edges.reshape(1, -1),
                                    want_sums=want_sums)
    return tuple(o[0] if o is not None else None for o in out)


def wcp_histogram_multi_ref(x: torch.Tensor, w: torch.Tensor,
                            edges: torch.Tensor, *, want_sums: bool = True):
    """Plain version of ``wcp_histogram_multi``: one shared ``x``/``w``
    (n,) binned against K realized ladders ``edges`` (K, nbins+1).
    Returns ``(cnt, wcnt, wsum)`` of shape ``(K, nbins + 2)``.  One ladder
    at a time (:func:`wcp_histogram_ref`), so no ``(K, n)`` tensor
    exists."""
    cnt, wcnt, wsum = zip(*(wcp_histogram_ref(x, w, e, want_sums=want_sums)
                            for e in edges))
    return (torch.stack(cnt), torch.stack(wcnt),
            torch.stack(wsum) if want_sums else None)
