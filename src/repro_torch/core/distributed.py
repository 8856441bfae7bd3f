"""Distributed selection over arrays sharded across ``torch.distributed``
ranks (the paper's Sec. V-D multi-GPU story).

Every function here is called by every rank of the groups it reduces over,
in the same order, each with its own shard; the results are replicated.
``axes`` (the reference's mesh axis names) is a ``ProcessGroup``, a
sequence of them (reduced over in turn) or ``None`` for the default group.
The ``sharded_*`` wrappers take the counterpart of the reference's
``(mesh, in_spec)``: a ``torch.distributed.device_mesh.DeviceMesh`` and the
name (or names) of the mesh dims the array is split over, in contiguous
shards, the first name's coordinate major (the reference's
``P(("a", "b"))``); the reduction groups are ``mesh.get_group(name)``.

Two primitives:

* :func:`local_order_statistic` — the k-th (or, with ``weights=``, the
  weighted) order statistic of a 1-D array sharded over ``axes``.  Each
  binned round is one local histogram pass (kernel K3 at one ladder on the
  card) and a cross-rank sum of the ``(nbins + 2,)`` slot-measure vector;
  each cutting-plane round sums the additive partials (kernel K4 at one
  pivot); ``method='binned_polish'`` also sums the per-slot sums (the
  sums legs at one ladder) and places the next round's edges around the
  global straddling-bin centroid.  The hybrid finalize compacts each shard
  into a fixed ``cap_local`` buffer, gathers the buffers and sorts.
  :func:`multi_order_statistic_across_shards` runs K targets through the
  local engine's loops on an :class:`~repro_torch.core.objective.
  FnEvaluator` whose closures sum the local multi-target passes.
* :func:`order_statistic_across_axis` — coordinate-wise order statistics
  ACROSS the ranks (each rank holds one replica of a coordinate array):
  the robust-gradient-aggregation workhorse behind
  :func:`repro_torch.core.robust.robust_aggregate`.

Collectives (:mod:`repro_torch.core.collectives`): integer counts and
minima / maxima go through ``all_reduce`` (exact); every float sum that
steers a round or a finalize — the cp partials, the weighted slot masses,
the polish's slot sums, the total mass, the mean, the finalize's masses —
is a gather of the per-rank vectors and a sum in rank order on every rank,
so every rank takes the same branch and every run gives the same bits.
The loop conditions read only replicated values.  The coordinate-sized
float vectors of the across-axis paths (the ``cp`` partials, the mean, the
trimmed mean's numerator) go through ``all_reduce`` SUM instead, in the
backend's order (a gather would cost ``n_rep`` times their size); every
rank still gets the same bits.

The reference's denormal caveat for the count-based across-axis methods
(flush-to-zero on XLA:CPU) does not apply: the port does not flush
denormals.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import collectives, selection
from repro_torch.core.collectives import pmax, pmin, psum, psum_backend
from repro_torch.core.objective import FG, FnEvaluator, ShardedEvaluator
from repro_torch.kernels import ops
from repro_torch.kernels.ref import _waccum_dtype, bin_edges

# round schedules of the 1-D distributed primitive ('auto' resolves by the
# global element count, as the local engine does)
DIST_METHODS = ("binned", "binned_polish", "cp", "auto")


def eval_fg_sharded(x_local, y, k, n_global, axes) -> FG:
    """Local fused pass and cross-rank combine: one
    :class:`ShardedEvaluator` call.  ``n_global`` overrides the summed
    element count (callers that pad shards pass the true count); ``None``
    takes it from the shards."""
    ev = ShardedEvaluator(x_local, k, axes)
    if n_global is not None:
        ev.n = int(n_global)
        ev.k = torch.clamp(torch.as_tensor(k, device=ev.x_local.device).to(
            torch.int64), 1, ev.n).to(torch.int32)
    return ev(torch.as_tensor(y, device=ev.x_local.device))


class _DistState(NamedTuple):
    yL: torch.Tensor
    fL: torch.Tensor
    gL: torch.Tensor
    yR: torch.Tensor
    fR: torch.Tensor
    gR: torch.Tensor
    loc_cleL: torch.Tensor  # this shard's count(x <= yL) (not replicated)
    loc_cleR: torch.Tensor
    max_in: torch.Tensor    # replicated: max over shards of the in-bracket
    t_exact: torch.Tensor
    found_exact: torch.Tensor
    it: int                 # rounds so far (the same on every rank)
    tp: torch.Tensor        # carried in-bin cut (drives the polish edges)


def _local_mass(x, w, c, mode: str) -> torch.Tensor:
    """This shard's mass of ``w`` over ``x <= c`` (``"le"``) or ``x < c``
    (``"lt"``), ``c`` a 0-dim value: ``ops.row_sums`` on the (1, n) view,
    as the local finalize measures it."""
    return ops.row_sums(x[None, :], w[None, :], c.reshape(1), mode,
                        dtype=w.dtype)[0]


def local_order_statistic(
    x_local: torch.Tensor,
    k,
    axes=None,
    *,
    maxit: int = 64,
    cap_local: int = 4096,
    method: str = "binned",
    nbins: int = selection.DEF_NBINS,
    weights: Optional[torch.Tensor] = None,
    prior=None,
) -> selection.SelectResult:
    """k-th smallest of the *global* array whose shard this rank holds;
    every rank of ``axes`` calls it with its shard.  The result (0-dim
    fields) is replicated.

    Exact under the guarantees of ``selection.order_statistic``; the
    stopping rule bounds the PER-SHARD in-bracket count (the max across
    ranks of each shard's count), so each shard's fixed ``cap_local``
    compaction never overflows whatever the imbalance.  ``iters`` counts
    rounds (the same on every rank).

    With ``weights`` (sharded like the data), ``k`` is the target
    cumulative MASS and the result the weighted order statistic: the
    evaluator swaps the measure, and the loop and finalize serve both legs.

    ``method``: ``'binned'`` (each round one local histogram pass and a
    cross-rank sum of the ``(nbins + 2,)`` slot measures; ~2-3 rounds),
    ``'binned_polish'`` (each round also sums the per-slot sums and places
    the next round's edges around the global straddling-bin centroid,
    ``selection.polish_edges``: one round saved at large n), ``'cp'``
    (cutting planes, one sum of the additive partials a round) or
    ``'auto'`` ('binned' for a global n of at least
    ``selection.BINNED_MIN_N``, else 'cp').  ``nbins`` defaults to 128 on
    every device, as the reference's.

    ``prior`` (warm start, replicated fields: a previous result or a
    ``selection.Prior``): round 1's edges come from
    ``selection.prior_edges`` (the cp schedule's first pivot is the prior
    value), so an unchanged answer re-certifies in one round; a stale,
    garbage or NaN prior costs rounds, never exactness.
    """
    pr = selection.as_prior(prior)
    weighted = weights is not None
    ev = ShardedEvaluator(x_local, k, axes, weights=weights)
    x_local = ev.x_local
    n_local = x_local.numel()
    if method == "auto":
        method = "binned" if ev.n >= selection.BINNED_MIN_N else "cp"
    if method not in DIST_METHODS:
        raise ValueError(f"unknown method {method!r}; one of "
                         f"{DIST_METHODS}")
    kk = ev.k
    dtype = x_local.dtype
    dev = x_local.device
    wl = ev.w_local.to(kk.dtype) if weighted else None

    # the analytic seeds of the local engine: the extremes, their support
    # lines and the polish's first cut
    b, xmin, xmax, _, _, xmean = selection._seed_state(ev)
    t0 = selection._seed_cut(ev, kk, xmin, xmax, xmean)
    bad0 = ~torch.isfinite(t0) | (t0 <= xmin) | (t0 >= xmax)
    t0 = torch.where(bad0, 0.5 * (xmin + xmax), t0).to(dtype)
    s = _DistState(
        yL=xmin, fL=b.fL, gL=b.gL, yR=xmax, fR=b.fR, gR=b.gR,
        loc_cleL=torch.zeros((), dtype=torch.int32, device=dev),
        loc_cleR=torch.full((), n_local, dtype=torch.int32, device=dev),
        # the largest shard (replicated: the loop condition reads it)
        max_in=pmax(torch.tensor(n_local, dtype=torch.int32, device=dev),
                    axes),
        t_exact=torch.full((), float("nan"), dtype=dtype, device=dev),
        found_exact=torch.zeros((), dtype=torch.bool, device=dev),
        it=0, tp=t0)

    def cp_body(s: _DistState, stalled):
        t = selection._propose_cp(s)
        bad = ~torch.isfinite(t) | (t <= s.yL) | (t >= s.yR)
        t = torch.where(bad, 0.5 * (s.yL + s.yR), t).to(s.yL.dtype)
        if pr is not None and s.it == 0:
            # warm start: the prior answer takes the FIRST round only
            # (finite and strictly inside the bracket); the summed
            # partials decide every move
            pv = torch.as_tensor(pr.value, device=dev).to(
                s.yL.dtype).reshape(())
            use = torch.isfinite(pv) & (pv > s.yL) & (pv < s.yR)
            t = torch.where(use, pv, t)
        # the local partials are kept too: the stopping rule bounds the
        # PER-SHARD in-bracket count, so the local compaction never
        # overflows
        loc = ev.local_partials(t)
        le_loc = loc[-1]   # n_le is the trailing partial on both legs
        fg = ev.combine(loc)
        exact = (fg.m_lt < kk) & (kk <= fg.m_le)
        move_left = fg.m_le < kk
        keep_r = move_left | exact
        loc_cleL = torch.where(move_left, le_loc, s.loc_cleL)
        loc_cleR = torch.where(keep_r, s.loc_cleR, le_loc)
        return _DistState(
            yL=torch.where(move_left, t, s.yL),
            fL=torch.where(move_left, fg.f.to(s.fL.dtype), s.fL),
            gL=torch.where(move_left, fg.g_hi.to(s.gL.dtype), s.gL),
            yR=torch.where(keep_r, s.yR, t),
            fR=torch.where(keep_r, s.fR, fg.f.to(s.fR.dtype)),
            gR=torch.where(keep_r, s.gR, fg.g_lo.to(s.gR.dtype)),
            loc_cleL=loc_cleL, loc_cleR=loc_cleR,
            max_in=pmax(loc_cleR - loc_cleL, axes),
            t_exact=torch.where(exact, t, s.t_exact),
            found_exact=s.found_exact | exact,
            it=s.it + 1, tp=s.tp,
        ), stalled

    polish = method == "binned_polish"
    pb = None  # the prior in the bracket dtype, for the binned rounds

    def binned_body(s: _DistState, stalled):
        # the realized edges are built ONCE and shared by the local pass
        # and the narrowing decision (the exactness contract); the local
        # slot counts stay per shard for the cap bookkeeping
        if pb is not None and s.it == 0:
            edges = selection.prior_edges(s.yL, s.yR, pb, nbins)
        elif polish:
            edges = selection.polish_edges(s.yL, s.yR, s.tp, nbins)
        else:
            edges = bin_edges(s.yL, s.yR, nbins)
        cnt_loc, mass_loc, msum_loc = ev.local_histogram(edges,
                                                         need_msum=polish)
        mass = psum(mass_loc, axes)
        if mass.dtype.is_floating_point:
            cum = torch.cumsum(mass[:-1], dim=-1)
        else:
            cum = torch.cumsum(mass[:-1], dim=-1, dtype=torch.int32)
        yLn, yRn, _, _, jm1, jstar, hit_lo, exact, stall = \
            selection.binned_descent_step(cum, edges, s.yL, s.yR, kk)
        # a late hit_lo can only be an inexact-mass flip: fail safe
        late_hit_lo = hit_lo & (s.it > 0)
        exact = exact & ~late_hit_lo
        stall = stall | late_hit_lo
        # this shard's prefix counts at the chosen edges (the cap rule)
        cum_loc = torch.cumsum(cnt_loc[:-1], dim=-1, dtype=torch.int32)
        upd = ~exact & ~stall
        loc_cleL = torch.where(upd, selection._take(cum_loc, jm1),
                               s.loc_cleL)
        loc_cleR = torch.where(upd, selection._take(cum_loc, jstar),
                               s.loc_cleR)
        tp = s.tp
        if polish:
            # the global straddling bin's mass centroid (the in-bin
            # support-line intersection); guard empty bins
            msum = psum(msum_loc, axes)
            mbin = selection._take(mass, jstar).to(msum.dtype)
            sbin = selection._take(msum, jstar)
            tcut = sbin / torch.where(mbin > 0, mbin, 1)
            good = (mbin > 0) & torch.isfinite(tcut)
            tcut = torch.where(good, selection._clip(tcut, yLn, yRn),
                               0.5 * (yLn + yRn)).to(s.yL.dtype)
            tp = torch.where(upd, tcut, s.tp)
        return s._replace(
            yL=torch.where(upd, yLn, s.yL),
            yR=torch.where(upd, yRn, s.yR),
            loc_cleL=loc_cleL, loc_cleR=loc_cleR,
            max_in=pmax(loc_cleR - loc_cleL, axes),
            t_exact=torch.where(exact, torch.where(hit_lo, s.yL, yRn),
                                s.t_exact),
            found_exact=s.found_exact | exact,
            it=s.it + 1, tp=tp,
        ), stalled | stall

    if method in ("binned", "binned_polish"):
        # brackets narrow to realized f32 edges: keep the bracket state at
        # (at least) the kernels' f32
        dt = torch.promote_types(dtype, torch.float32)
        s = s._replace(yL=s.yL.to(dt), yR=s.yR.to(dt),
                       t_exact=s.t_exact.to(dt), tp=s.tp.to(dt))
        if pr is not None:
            pb = selection.Prior(*(torch.as_tensor(f, device=dev).to(
                dt).reshape(()) for f in pr))
            # the prior's carried cut beats the analytic polish seed
            okc = torch.isfinite(pb.cut) & (pb.cut > s.yL) & (pb.cut < s.yR)
            s = s._replace(tp=torch.where(okc, pb.cut, s.tp))
        body = binned_body
    else:
        body = cp_body

    # every value the condition reads is replicated
    stalled = torch.zeros((), dtype=torch.bool, device=dev)
    while s.it < maxit and bool((~s.found_exact) & ~stalled
                                & (s.max_in > cap_local) & (s.yR > s.yL)):
        s, stalled = body(s, stalled)

    # ---- distributed hybrid finalize (compact per shard, gather, sort) ----
    big = torch.tensor(float("inf"), dtype=dtype, device=dev)
    lo, hi = s.yL.reshape(1), s.yR.reshape(1)  # (1,): bf16 compares in f32
    mask_in = (x_local > lo) & (x_local <= hi)
    cols = [(x_local[None, :], big)]
    if weighted:
        cols.append((wl[None, :], torch.zeros((), dtype=wl.dtype,
                                              device=dev)))
    bufs, loc_in = selection.rank_compact(mask_in[None, :], cap_local, cols)
    loc_in = loc_in[0]
    n_in = psum(loc_in, axes)
    z_all = collectives.all_gather(bufs[0][0], axes)
    ok_gather = pmax(loc_in, axes) <= cap_local
    vnext = pmin(torch.amin(torch.where(x_local > lo, x_local, big)), axes)

    if weighted:
        # the aligned weight buffers resolve by sorted prefix masses
        zs, zws = selection._sort_buffers(
            z_all, collectives.all_gather(bufs[1][0], axes))
        cLm = psum(_local_mass(x_local, wl, s.yL, "le"), axes)
        reach = cLm + torch.cumsum(zws, dim=-1) >= kk
        ans_sort = zs[torch.argmax(reach.to(torch.int32))]
        # the buffer certifies only when its mass actually reaches k
        ok_sort = ok_gather & reach[-1]
        m_le_v = psum(_local_mass(x_local, wl, vnext, "le"), axes)
        m_lt_max = psum(_local_mass(x_local, wl, xmax, "lt"), axes)
        # extreme shortcuts gated on the seed bracket (re-measured masses
        # can flip near k; only a bracket still AT the extreme certifies)
        at_min = (cLm >= kk) & (s.yL == xmin)
        at_max = (m_lt_max < kk) & (s.yR == xmax)
        t_hit, y_hi = s.t_exact.to(dtype), s.yR.to(dtype)
    else:
        zs = torch.sort(z_all).values
        cLm = psum(torch.sum(x_local <= lo, dtype=torch.int32), axes)
        ans_sort = zs[torch.clamp(kk - cLm - 1, 0, zs.numel() - 1)]
        ok_sort = ok_gather
        m_le_v = psum(torch.sum(x_local <= vnext, dtype=torch.int32), axes)
        m_lt_max = psum(torch.sum(x_local < xmax, dtype=torch.int32), axes)
        at_min = cLm >= kk
        at_max = m_lt_max < kk
        t_hit, y_hi = s.t_exact, s.yR

    fallback_ok = (cLm < kk) & (kk <= m_le_v)
    value = torch.where(
        s.found_exact, t_hit,
        torch.where(ok_sort, ans_sort, torch.where(fallback_ok, vnext,
                                                   y_hi)))
    status = torch.where(
        s.found_exact, selection.EXACT_HIT,
        torch.where(ok_sort, selection.HYBRID_SORT,
                    torch.where(fallback_ok, selection.TIE_FALLBACK,
                                selection.NOT_CONVERGED)))
    value = torch.where(at_min, xmin, torch.where(at_max, xmax, value))
    status = torch.where(at_min | at_max, selection.EXACT_HIT, status)
    return selection.SelectResult(
        value=value, iters=torch.tensor(s.it, dtype=torch.int32, device=dev),
        status=status.to(torch.int32), y_lo=s.yL, y_hi=s.yR, n_in=n_in)


def local_weighted_order_statistic(
    x_local: torch.Tensor,
    w_local: torch.Tensor,
    wk,
    axes=None,
    *,
    maxit: int = 64,
    cap_local: int = 4096,
    method: str = "binned",
    nbins: int = selection.DEF_NBINS,
    prior=None,
) -> selection.SelectResult:
    """Weighted order statistic of the *global* sharded array: the smallest
    element whose global cumulative weight reaches ``wk`` (weights sharded
    like the data).  :func:`local_order_statistic` on the weighted leg:
    each binned round sums the slot MASS vector in rank order (the counts
    stay per shard for the cap rule), and the finalize gathers (value,
    weight) buffers and resolves by sorted prefix masses."""
    if method not in DIST_METHODS:
        raise ValueError(f"unknown method {method!r}; one of "
                         f"{DIST_METHODS}")
    return local_order_statistic(
        x_local, wk, axes, maxit=maxit, cap_local=cap_local, method=method,
        nbins=nbins, weights=w_local, prior=prior)


def _mesh_groups(mesh, in_spec) -> tuple:
    """The process groups of the mesh dims named by ``in_spec`` (a name or
    a sequence of names, ``None`` entries and nested tuples flattened as
    the reference flattens a ``PartitionSpec``)."""
    names = [in_spec] if isinstance(in_spec, str) else list(in_spec)
    flat = [a for ax in names for a in
            ((ax,) if isinstance(ax, str) else tuple(ax or ()))]
    return tuple(mesh.get_group(a) for a in flat)


def _global_size(x_local: torch.Tensor, axes) -> int:
    return int(psum(torch.tensor(x_local.numel(), dtype=torch.int64,
                                 device=x_local.device), axes))


def sharded_order_statistic(x_local, k, mesh, in_spec,
                            **kwargs) -> selection.SelectResult:
    """The k-th smallest of the array split over the ``mesh`` dims
    ``in_spec`` (this rank's contiguous shard ``x_local``); replicated."""
    return local_order_statistic(x_local, k, _mesh_groups(mesh, in_spec),
                                 **kwargs)


def sharded_median(x_local, mesh, in_spec, **kw) -> selection.SelectResult:
    """Med(x) = x_([(n+1)/2]) of the sharded array (n the global count)."""
    n = _global_size(x_local, _mesh_groups(mesh, in_spec))
    return sharded_order_statistic(x_local, (n + 1) // 2, mesh, in_spec,
                                   **kw)


def sharded_weighted_order_statistic(x_local, w_local, wk, mesh, in_spec,
                                     **kwargs) -> selection.SelectResult:
    """The weighted order statistic of the sharded array (``w_local``
    sharded like ``x_local``); replicated."""
    return local_weighted_order_statistic(
        x_local, w_local, wk, _mesh_groups(mesh, in_spec), **kwargs)


def sharded_weighted_median(x_local, w_local, mesh, in_spec,
                            **kw) -> selection.SelectResult:
    """Lower weighted median of the sharded array (global mass / 2, the
    mass summed across ranks as the evaluator sums it)."""
    axes = _mesh_groups(mesh, in_spec)
    w_local = torch.as_tensor(w_local, device=x_local.device)
    W = psum(selection._total_mass(x_local, w_local), axes)
    return sharded_weighted_order_statistic(x_local, w_local, 0.5 * W, mesh,
                                            in_spec, **kw)


def sharded_quantile(x_local, q, mesh, in_spec,
                     **kw) -> selection.SelectResult:
    """Lower empirical q-quantile of the sharded array (its rank resolved
    on the host in f64, ``selection.ranks_from_quantiles``)."""
    n = _global_size(x_local, _mesh_groups(mesh, in_spec))
    return sharded_order_statistic(
        x_local, selection.ranks_from_quantiles(q, n), mesh, in_spec, **kw)


def multi_order_statistic_across_shards(
    x_local: torch.Tensor,
    ks,
    axes=None,
    *,
    maxit: int = 64,
    cap_local: int = 4096,
    method: str = "binned",
    nbins: int = selection.DEF_NBINS,
    weights: Optional[torch.Tensor] = None,
    prior=None,
) -> selection.SelectResult:
    """K order statistics of the *global* sharded array in ONE round loop;
    replicated ``(K,)`` fields.

    The loop is the local engine's (``selection.binned_loop_batched`` /
    ``bracket_loop_batched``) on an :class:`FnEvaluator` whose closures sum
    the local multi-target passes across ranks: each binned round is one
    local pass for all K ladders (kernel K3 on the card) and one sum of
    the ``(K, nbins + 2)`` slot matrix, so a decile vector costs the
    rounds of a median.  The count matrix also rides a MAX across ranks:
    its prefix differences bound the WORST shard's in-bracket count, so
    the engine's cap rule sizes every shard's compaction buffer.  With
    ``weights`` the targets are masses and the mass matrix is summed next
    to the counts; ``'binned_polish'`` sums the per-slot sums too;
    ``'cp'`` sums the ``(K,)`` partials (kernel K4); ``'auto'`` as in
    :func:`local_order_statistic`.

    The finalize is a Python loop over the K targets, in the same order on
    every rank: each compacts its shard's survivors into a ``cap_local``
    buffer (no ``(K, n)`` tensor), then the small per-target buffers and
    measures cross the ranks together and resolve through the engine's
    answer cascade (``selection._assemble_answers``).
    """
    x_local = x_local.reshape(-1).contiguous()
    dev = x_local.device
    dtype = x_local.dtype
    n_glob = _global_size(x_local, axes)
    if method == "auto":
        method = "binned" if n_glob >= selection.BINNED_MIN_N else "cp"
    weighted = weights is not None
    big = torch.tensor(float("inf"), dtype=dtype, device=dev)

    if weighted:
        wl = torch.as_tensor(weights, device=dev).reshape(-1).broadcast_to(
            x_local.shape)
        mdt = _waccum_dtype(x_local, wl)
        W = psum(torch.sum(wl, dtype=mdt), axes)
        kk = torch.minimum(torch.as_tensor(ks, dtype=mdt, device=dev)
                           .reshape(-1), W)
        wl = wl.to(mdt).contiguous()

        def partials(y):
            wsp, wsn, wlt, wle, lt, le = ops.fused_weighted_partials_multi(
                x_local, wl, y)
            f = psum(torch.stack([wsp, wsn, wlt, wle]), axes)
            c = psum(torch.stack([lt, le]), axes)
            return f[0], f[1], f[2], f[3], c[0], c[1]

        def histogram(edges, need_msum=False):
            cnt, wcnt, wsum = ops.fused_weighted_histogram_multi(
                x_local, wl, edges, want_sums=need_msum)
            return (pmax(cnt, axes), psum(wcnt, axes),
                    psum(wsum, axes) if need_msum else None)
    else:
        wl = W = None
        kk = torch.clamp(torch.as_tensor(ks, device=dev).reshape(-1).to(
            torch.int64), 1, n_glob).to(torch.int32)

        def partials(y):
            sp, sn, lt, le = ops.fused_partials_multi(x_local, y)
            f = psum(torch.stack([sp, sn]), axes)
            c = psum(torch.stack([lt, le]), axes)
            return f[0], f[1], c[0], c[1]

        def histogram(edges, need_msum=False):
            # the summed slot matrix drives the narrowing; the MAX of the
            # count matrix feeds the cap rule (sum of per-slot maxima >=
            # every shard's in-bracket count)
            cnt, bsum = ops.fused_histogram_multi(x_local, edges,
                                                  want_sums=need_msum)
            return (pmax(cnt, axes), psum(cnt, axes),
                    psum(bsum, axes) if need_msum else None)

    nk = kk.shape[0]

    def init_stats():
        gmin = pmin(torch.amin(x_local), axes)
        gmax = pmax(torch.amax(x_local), axes)
        if weighted:
            wx = psum(torch.sum(wl * x_local, dtype=mdt), axes)
            mean = wx / torch.clamp(W, min=1e-30)
        else:
            mean = psum(torch.sum(x_local, dtype=torch.promote_types(
                dtype, torch.float32)), axes) / n_glob
        return (gmin.broadcast_to((nk,)), gmax.broadcast_to((nk,)),
                mean.to(dtype).broadcast_to((nk,)))

    ev = FnEvaluator(partials, n_glob, kk, init_stats, histogram=histogram,
                     weights_total=W)
    s, xmin, xmax = selection._run_bracket_phase(
        ev, method, maxit, cap_local, nbins, prior=selection.as_prior(prior))

    # ---- distributed finalize: compact per shard per target, gather,
    # assemble (one Python loop over the targets, the same on every rank)
    cols = [(x_local[None, :], big)]
    if weighted:
        cols.append((wl[None, :], torch.zeros((), dtype=mdt, device=dev)))
    z, zw, loc_in, vn_loc, cl_loc = [], [], [], [], []
    for j in range(nk):
        lo, hi = s.yL[j:j + 1], s.yR[j:j + 1]   # (1,): bf16 compares in f32
        mask_in = (x_local > lo) & (x_local <= hi)
        bufs, n_j = selection.rank_compact(mask_in[None, :], cap_local, cols)
        z.append(bufs[0][0])
        if weighted:
            zw.append(bufs[1][0])
            cl_loc.append(_local_mass(x_local, wl, lo, "le"))
        else:
            cl_loc.append(torch.sum(x_local <= lo, dtype=torch.int32))
        loc_in.append(n_j[0])
        vn_loc.append(torch.amin(torch.where(x_local > lo, x_local, big)))
    loc_in = torch.stack(loc_in)
    z = collectives.all_gather(torch.stack(z), axes, dim=1)
    ok = pmax(loc_in, axes) <= cap_local
    n_in = psum(loc_in, axes)
    vnext = pmin(torch.stack(vn_loc), axes)
    cLm = psum(torch.stack(cl_loc), axes)
    top = torch.amax(xmax).reshape(1)
    if weighted:
        zs, zws = selection._sort_buffers(
            z, collectives.all_gather(torch.stack(zw), axes, dim=1))
        m_le_v = psum(torch.stack([_local_mass(x_local, wl, vnext[j], "le")
                                   for j in range(nk)]), axes)
        m_lt_max = psum(_local_mass(x_local, wl, top, "lt"), axes)
    else:
        zs, zws = torch.sort(z, dim=-1).values, None
        m_le_v = psum(torch.stack([
            torch.sum(x_local <= vnext[j:j + 1], dtype=torch.int32)
            for j in range(nk)]), axes)
        m_lt_max = psum(torch.sum(x_local < top, dtype=torch.int32), axes)
    gcap = zs.shape[-1]
    # a shard's buffer overflow must fail the sort path even when the
    # GLOBAL count fits the gathered width (survivors were dropped locally)
    n_in_eff = torch.where(ok, n_in, gcap + 1)
    res = selection._assemble_answers(kk, s, gcap, zs, zws, cLm, n_in_eff,
                                      vnext, m_le_v,
                                      m_lt_max.broadcast_to((nk,)), xmin,
                                      xmax)
    return res._replace(n_in=n_in)


def sharded_multi_order_statistic(x_local, ks, mesh, in_spec,
                                  **kwargs) -> selection.SelectResult:
    """K order statistics of the sharded array (``ks`` the (K,) ranks, or
    masses with ``weights=`` sharded like ``x_local``); replicated (K,)
    fields."""
    return multi_order_statistic_across_shards(
        x_local, ks, _mesh_groups(mesh, in_spec), **kwargs)


def sharded_quantiles(x_local, qs, mesh, in_spec,
                      **kw) -> selection.SelectResult:
    """Lower empirical quantiles of the sharded array from one multi-k
    solve (a decile vector costs the rounds of a median)."""
    n = _global_size(x_local, _mesh_groups(mesh, in_spec))
    return sharded_multi_order_statistic(
        x_local, selection.ranks_from_quantiles(qs, n), mesh, in_spec, **kw)


# ---------------------------------------------------------------------------
# Coordinate-wise selection ACROSS the ranks
# ---------------------------------------------------------------------------


def _replica_count(mask: torch.Tensor, axes, n_rep: int) -> torch.Tensor:
    """The number of replicas where ``mask`` holds, per coordinate: an
    exact integer sum across ranks carried as uint8 (a count is at most
    ``n_rep``; a quarter of int32's bytes on the wire) up to 255 replicas,
    returned as int32."""
    cdt = torch.uint8 if n_rep < 256 else torch.int32
    return psum(mask.to(cdt), axes).to(torch.int32)


def axis_evaluator(v_local: torch.Tensor, k, axes) -> FnEvaluator:
    """Evaluator for coordinate-wise selection ACROSS ranks.

    The batch is the coordinate set (``v_local``'s shape S); each
    coordinate's data are the ``n_rep`` replica values, one per rank of
    ``axes``.  The cp partials are four S-shaped vectors summed across
    ranks (the two f32 ones by ``all_reduce`` in the backend's order); the
    binned pass one-hots this rank's value against each coordinate's
    ladder and sums the ``(S..., nbins + 2)`` counts — the replica data
    never move.  The counts cross the wire as uint8
    (:func:`_replica_count`)."""
    v = v_local.to(torch.float32)
    n_rep = collectives.axis_size(axes)
    kk = torch.clamp(torch.as_tensor(k, device=v.device).to(torch.int64), 1,
                     n_rep).to(torch.int32).broadcast_to(v.shape)
    zero = torch.zeros((), dtype=v.dtype, device=v.device)

    def partials(y):
        d = v - y
        return (psum_backend(torch.maximum(d, zero), axes),
                psum_backend(torch.maximum(-d, zero), axes),
                _replica_count(d < 0, axes, n_rep),
                _replica_count(d <= 0, axes, n_rep))

    def histogram(edges, need_msum=False):              # (S..., nbins + 1)
        cap = torch.full_like(edges[..., :1], float("inf"))
        lower = torch.cat([-cap, edges], dim=-1)
        upper = torch.cat([edges, cap], dim=-1)
        # slot 0 takes v == -inf too (the kernels' slot layout)
        first = torch.arange(edges.shape[-1] + 1, device=v.device) == 0
        m = ((v[..., None] > lower) | first) & (v[..., None] <= upper)
        # the counting measure: the summed counts are both the count and
        # the mass vector; no per-bin sums (no polish across ranks)
        cnt = _replica_count(m, axes, n_rep)
        return cnt, cnt, None

    def init_stats():
        return (pmin(v, axes), pmax(v, axes), psum_backend(v, axes) / n_rep)

    return FnEvaluator(partials, n_rep, kk, init_stats, histogram=histogram)


def order_statistic_across_axis(
    v_local: torch.Tensor,
    k: int,
    axes=None,
    *,
    maxit: int = 48,
    method: str = "auto",
    gather_threshold: int = 32,
    nbins: int = 32,
) -> torch.Tensor:
    """Coordinate-wise k-th order statistic across the ranks of ``axes``.

    ``v_local`` is this rank's replica, any shape S; the result (shape S,
    ``v_local``'s dtype, replicated) holds each coordinate's k-th smallest
    over the replicas.  ``method``: ``'gather'`` gathers the replicas and
    sorts; ``'binned'`` runs the histogram descent on an
    :func:`axis_evaluator` (each round one sum of ``(S..., nbins + 2)``
    counts, ~3 rounds); ``'cp'`` the paper's cutting planes (four
    S-shaped sums a round); ``'auto'`` is ``'gather'`` for at most
    ``gather_threshold`` replicas, else ``'binned'``.  The count-based
    methods see denormals as they are (the port does not flush them to
    zero, as the reference's compiled CPU code does)."""
    n_rep = collectives.axis_size(axes)
    if method == "auto":
        method = "gather" if n_rep <= gather_threshold else "binned"
    if method == "gather":
        g = collectives.all_gather(v_local[None], axes)
        gs = torch.sort(g, dim=0).values
        return gs[min(max(int(k) - 1, 0), n_rep - 1)]
    if method not in ("cp", "binned"):
        raise ValueError(f"unknown method {method!r}")

    v = v_local.to(torch.float32)
    ev = axis_evaluator(v_local, k, axes)
    kk = ev.k
    # coordinates whose answer sits at an extreme (k == 1, k == n_rep,
    # all-equal coordinates) can never exact-hit at an interior pivot:
    # certify them before the loop and keep them frozen
    yL0, yR0, _ = ev.init_stats()
    at_min = _replica_count(v <= yL0, axes, n_rep) >= kk
    at_max = _replica_count(v < yR0, axes, n_rep) < kk
    found0 = at_min | at_max
    t0 = torch.where(at_min, yL0, torch.where(at_max, yR0, float("nan")))
    if method == "binned":
        # cap=1: a coordinate stops once one replica value is bracketed
        # (the fallback below recovers it) or a certificate fires
        s, _, _ = selection.binned_loop_batched(
            ev, nbins=nbins, maxit=maxit, cap=1, found0=found0, t0=t0)
    else:
        # cap=0: iterate to an exact hit (or maxit); the replica data
        # never move, so the finalize is certificate + tie fallback only
        s, _, _ = selection.bracket_loop_batched(
            ev, method="cp", maxit=maxit, cap=0, found0=found0, t0=t0)
    # tie fallback: the next distinct value above yL, certified by counts
    vnext = pmin(torch.where(v > s.yL, v, float("inf")), axes)
    n_le_v = _replica_count(v <= vnext, axes, n_rep)
    fb_ok = (s.cleL < kk) & (kk <= n_le_v)
    ans = torch.where(s.found_exact, s.t_exact,
                      torch.where(fb_ok, vnext, s.yR))
    return ans.to(v_local.dtype)


def median_across_axis(v_local, axes=None, **kw) -> torch.Tensor:
    """Coordinate-wise median across the ranks (k = (n_rep + 1) // 2)."""
    n_rep = collectives.axis_size(axes)
    return order_statistic_across_axis(v_local, (n_rep + 1) // 2, axes, **kw)
