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
    (B,); returns four (B,) tensors, each row reduced alone
    (:func:`_by_row`)."""
    dt = _accum_dtype(x)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1, 1)
    return _by_row(_partials, x.to(dt) - y)


def cp_partials_multi_ref(x: torch.Tensor, y):
    """Plain version of ``cp_partials_multi``: one shared ``x`` (n,) and
    pivots ``y`` (K,); returns four (K,) tensors.  One pivot at a time, so
    no ``(K, n)`` tensor exists."""
    dt = _accum_dtype(x)
    x = x.reshape(-1).to(dt)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1)
    parts = [_partials(x - yj, dim=-1) for yj in y]
    return tuple(torch.stack(p) for p in zip(*parts))


def _by_row(fn, *rows: torch.Tensor):
    """``fn(*tensors, dim=-1)`` on (B, n) tensors, each row reduced alone
    and the (B,) results stacked: torch splits a reduction over a whole
    block by its shape and threads, so a row's f32 sums would otherwise
    depend on the other rows."""
    if rows[0].shape[0] == 0:
        return fn(*rows, dim=-1)
    parts = [fn(*r, dim=-1) for r in zip(*(t.unbind(0) for t in rows))]
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


def row_sums_ref(x: torch.Tensor, w=None, c=None, mode: str = "mass", *,
                 dtype: torch.dtype) -> torch.Tensor:
    """Plain version of ``cp_objective.row_sums``: per-row sums in
    ``dtype`` over ``x`` (B, n) of ``x`` itself (``w=None``), or of its
    weights ``w``: all of them (``"mass"``), ``w * x`` (``"moment"``), those
    over ``x <= c`` (``"le"``) or ``x < c`` (``"lt"``), ``c`` (B,).  Each
    row is summed alone (``torch.sum`` of the row), so its sum does not
    depend on the other rows, whose number changes how torch splits a
    reduction over the whole block."""
    if w is None:
        v = x
    elif mode == "mass":
        v = w
    elif mode == "moment":
        v = w * x
    elif mode in ("le", "lt"):
        zero = torch.zeros((), dtype=w.dtype, device=w.device)
        v = torch.where(x <= c[:, None] if mode == "le" else x < c[:, None],
                        w, zero)
    else:
        raise ValueError(f"unknown row_sums mode {mode!r}")
    if v.shape[0] == 0:
        return torch.zeros((0,), dtype=dtype, device=v.device)
    return torch.stack([torch.sum(r, dtype=dtype) for r in v.unbind(0)])


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
    pivots ``y`` (B,); returns six (B,) tensors, each row reduced alone
    (:func:`_by_row`)."""
    dt = _waccum_dtype(x, w)
    y = torch.as_tensor(y, dtype=dt, device=x.device).reshape(-1, 1)
    return _by_row(_wpartials, x.to(dt) - y, w.to(dt).broadcast_to(x.shape))


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


# ---------------------------------------------------------------------------
# Segmented selection: each element binned against its OWN segment's ladder
# (the per-leaf quantile pass), and reductions of contiguous groups in an
# order set by each group alone
# ---------------------------------------------------------------------------

# Elements per row of a group reduction's tree (a power of two).
GROUP_WIDTH = 128

_IDENTITY = {"sum": -0.0, "min": float("inf"), "max": float("-inf")}
_COMBINE = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


class GroupPlan:
    """Reductions of contiguous groups, each in an order set by its own
    elements alone.

    ``gid`` (m,) holds each element's group id in ``[0, ngroups)`` and is
    nondecreasing, so every group is a contiguous run (``start`` and
    ``size`` per group; :meth:`tally` counts a mask per group).  A group's
    reduction (:meth:`reduce`) is a tree over its own elements in data
    order: rows of :data:`GROUP_WIDTH` from its first element (the last
    row padded with the operation's identity, ``-0.0`` for sums), each row
    reduced by
    pairwise halving, then the group's row results the same way, level by
    level, down to one value.  The tree's shape follows the group's size
    alone, and it is made of elementwise operations only: no atomics, and
    no library reduction whose order follows the shape of its launch.  So
    a group's result does not depend on the other groups (their number,
    sizes or values) nor on the device: the CPU and the card give the same
    bits.  Extra levels (more elements elsewhere) only add the identity.

    The plan (each level's destinations) is built once per ``gid``; every
    bound is static (from ``m`` and ``ngroups``), so building it and
    reducing with it never read a value back to the host.  Group
    ``ngroups`` (past the real ones) holds each level's padding rows.
    """

    def __init__(self, gid: torch.Tensor, ngroups: int):
        dev = gid.device
        w = GROUP_WIDTH
        gid = gid.reshape(-1)
        m = gid.numel()
        g1 = ngroups + 1
        # the groups' bounds by binary search on the sorted ids (a bincount
        # of sorted ids makes every thread of a block hit one bin)
        bounds = torch.searchsorted(gid, torch.arange(
            g1, dtype=gid.dtype, device=dev))
        self.ngroups = ngroups
        self.start = bounds[:ngroups]
        self.size = bounds[1:] - self.start
        cnt = torch.cat([self.size, self.size.new_zeros(1)])
        # int32 cumsums of masks (``tally``) while they cannot overflow
        self._cdt = torch.int32 if m < 2 ** 31 else torch.int64
        pos = torch.arange(m, device=dev) - self.start[gid]
        self.levels = []
        bound = m  # the largest real group's element count, at most
        while True:
            rows = (cnt + (w - 1)) // w
            ends = torch.cumsum(rows, 0)
            row0 = ends - rows
            nrows = m // w + g1  # >= sum(rows): static
            self.levels.append((row0[gid] * w + pos, nrows))
            if bound <= w:
                break
            bound = -(-bound // w)
            # the next level's elements are this level's nrows results:
            # group g's rows row0[g] .. ends[g] - 1, the rest in group
            # ngroups (padding)
            r = torch.arange(nrows, device=dev)
            gid = torch.clamp(torch.bucketize(r, ends[:ngroups], right=True),
                              max=ngroups)
            cnt = rows.clone()
            cnt[ngroups] += nrows - ends[ngroups]
            pos = r - row0[gid]
            m = nrows
        self.row = row0[:ngroups]
        self.nonempty = rows[:ngroups] > 0

    def tally(self, mask: torch.Tensor) -> torch.Tensor:
        """int32 count of True in each group of ``mask`` (m,): differences
        of one integer cumsum at the groups' bounds."""
        c = torch.cumsum(mask, 0, dtype=self._cdt)
        last = c[torch.clamp(self.start + self.size - 1, min=0)]
        first = torch.where(self.start > 0, c[torch.clamp(self.start - 1,
                                                          min=0)], 0)
        return torch.where(self.size > 0, last - first, 0).to(torch.int32)

    def reduce(self, vals: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``op`` ('sum', 'min' or 'max') of each group of ``vals`` ((m,) or
        (m, c): c columns at once) in ``vals``' dtype; returns (ngroups,)
        (or (ngroups, c)).  NaN propagates; sums are returned with ``+0.0``
        for an empty group or a zero total, as a sum that starts at 0."""
        ident = _IDENTITY[op]
        combine = _COMBINE[op]
        w = GROUP_WIDTH
        v = vals
        for dest, nrows in self.levels:
            buf = torch.full((nrows * w,) + tuple(v.shape[1:]), ident,
                             dtype=v.dtype, device=v.device)
            buf[dest] = v
            buf = buf.view((nrows, w) + tuple(v.shape[1:]))
            width = w
            while width > 1:
                width //= 2
                buf = combine(buf[:, :width], buf[:, width:])
            v = buf[:, 0]
        keep = self.nonempty.reshape((-1,) + (1,) * (v.dim() - 1))
        out = torch.where(keep, v[self.row], torch.full((), ident,
                                                        dtype=v.dtype,
                                                        device=v.device))
        return out + 0.0 if op == "sum" else out


def segmented_slots(x: torch.Tensor, seg: torch.Tensor,
                    edges: torch.Tensor) -> torch.Tensor:
    """Each element's slot within its own segment's ladder:
    ``searchsorted_slots(x_i, edges[seg_i])`` without per-element edge rows.

    A branchless binary search over the flattened ``(K, nbins+1)`` edge
    array — ``ceil(log2(nbins+2))`` rounds of (n,)-shaped gathers, so no
    ``(n, nbins)`` or ``(K, n)`` tensor exists — comparing against the
    REALIZED edges: ``pos = count(edges[seg] < x)``, NaN forced to the top
    slot (every NaN comparison is false, so the search walks right).
    Returns int32 slots shaped like ``x``."""
    ne = edges.shape[-1]
    # each ladder padded with +inf to p = 2^b > ne entries: no x exceeds a
    # pad, so the search needs no bounds checks
    p = 1 << ne.bit_length()
    ef = torch.full((edges.shape[0], p), float("inf"), dtype=edges.dtype,
                    device=edges.device)
    ef[:, :ne] = edges
    ef = ef.reshape(-1)
    # ptr = seg * p - 1 + pos; invariant: every edges[seg][:pos] < x; steps
    # p/2, .., 1 reach any count in [0, p - 1]
    base = seg.to(torch.int32) * p - 1
    ptr = base
    step = p // 2
    while step:
        cand = ptr + step
        ptr = torch.where(ef[cand] < x, cand, ptr)
        step //= 2
    return torch.where(torch.isnan(x), ne, ptr - base).to(torch.int32)


def segmented_histogram_ref(x: torch.Tensor, seg: torch.Tensor,
                            edges: torch.Tensor, rows=()):
    """Per-segment histograms in one data pass: element ``i`` lands in slot
    ``segmented_slots(x, seg, edges)[i]`` of segment ``seg[i]``'s
    ``(nbins+2,)`` vector (``edges`` (K, nbins+1)).  Returns
    ``[cnt int32, *sums]``, each ``(K, nbins+2)``: the counts by integer
    ``bincount`` of the flattened slot ``seg*(nbins+2) + slot``, and one
    per-slot sum in the edges' dtype for each tensor of ``rows`` (aligned
    with ``x``).  The sums group the elements by flattened slot with one
    stable sort (data order inside a slot) and reduce each slot with
    :class:`GroupPlan`, so a slot's sum depends on its own elements only
    and no f32 atomics run."""
    kk = edges.shape[0]
    nslots = edges.shape[-1] + 1
    dt = edges.dtype
    x = x.to(dt)
    flat = seg.to(torch.int64) * nslots + segmented_slots(x, seg, edges)
    cnt = torch.bincount(flat, minlength=kk * nslots)[:kk * nslots]
    out = [cnt.reshape(kk, nslots).to(torch.int32)]
    if rows:
        flat, order = torch.sort(flat, stable=True)
        plan = GroupPlan(flat, kk * nslots)
        vals = torch.stack([torch.as_tensor(v).to(dt).reshape(-1)[order]
                            for v in rows], dim=-1)
        sums = plan.reduce(vals)
        out += [sums[:, j].reshape(kk, nslots) for j in range(len(rows))]
    return out
