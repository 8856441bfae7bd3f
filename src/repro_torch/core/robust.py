"""Robust statistics built on selection — the paper's Sec. VI applications
and the training-side quantile clip, ported from ``repro.core.robust``.

* LMS (Least Median of Squares, Rousseeuw 1984): minimize Med(r_i^2).
* LTS (Least Trimmed Squares): minimize the sum of the h smallest squared
  residuals, evaluated WITHOUT sorting by the paper's rho/(a,b) trick
  (Eq. 4): with m = r^2_(h), b_L = count(r^2 < m) and a = h - b_L,

      F(theta) = sum_{r^2 < m} r^2 + a * m

  which is the sum of exactly h smallest squared residuals.
* FAST-LTS fitting: random elemental starts, then concentration steps
  (Rousseeuw & Van Driessen); each step's h-th order statistic comes from
  one rows-mode selection over the whole ``(n_starts, n)`` residual block,
  and the trimmed refit is a weighted least squares with fractional tie
  weights a/b, so ties keep exactly h points in total weight.
* Theil-Sen and IRLS M-estimation, on the weighted selection engine.
* kNN by order statistic (no sort): indicator weights from d_(k).
* Quantile clipping of gradient pytrees: a global threshold by a
  cutting-plane loop over the leaves, exact per-leaf thresholds by one
  segmented solve, and a two-pass histogram estimate.

PyTorch idiom: the reference's ``lax.scan`` is a host loop, its ``vmap`` a
batch dimension written out (one batched solve over ``(B, p, p)``), its
PRNG key a ``torch.Generator`` (or an int seed) on the data's device, and
its pytrees nested dicts, lists and tuples flattened here with dict keys
sorted as ``jax.tree`` sorts them.  Every entry point computes on the
device of the tensors it is given.  ``robust_aggregate`` (the distributed
combine) is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core import selection
from repro_torch.core.objective import fg_from_partials
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# LMS / LTS objectives
# ---------------------------------------------------------------------------


def residuals(theta, X, y):
    return X @ theta - y


def lms_objective(theta, X, y, **kw):
    """Med(r^2) (Rousseeuw's LMS criterion)."""
    r2 = residuals(theta, X, y) ** 2
    return selection.median(r2, **kw).value


def lts_objective_from_residuals(r, h, **kw):
    """Sum of the h smallest squared residuals by the rho/(a,b) trick: the
    ``B = 1`` view of :func:`lts_objective_rows`."""
    return lts_objective_rows(r.reshape(1, -1), h, **kw)[0]


def lts_objective_rows(R, h, **kw):
    """Row-wise LTS criterion: ``R`` is (B, n) residuals, one value per row
    from one rows-mode selection.  The sum below the cutoff is a per-row
    sum that does not depend on the other rows (``ops.row_sums``, the
    weights being the squares themselves)."""
    a2 = R * R
    m = selection.select_rows(a2, h, **kw).value
    below = ops.row_sums(a2, a2, m, "lt", dtype=a2.dtype)
    b_lo = torch.sum(a2 < m[:, None], dim=1, dtype=torch.int32)
    a = (h - b_lo).to(a2.dtype)
    return below + a * m


def lts_objective(theta, X, y, h=None, **kw):
    n, p = X.shape
    if h is None:
        h = (n + p + 1) // 2  # [(n+p)/2] + parity-safe default
    return lts_objective_from_residuals(residuals(theta, X, y), h, **kw)


# ---------------------------------------------------------------------------
# Fitting: random elemental starts + concentration steps
# ---------------------------------------------------------------------------


class RobustFit(NamedTuple):
    theta: torch.Tensor
    objective: torch.Tensor
    inlier_weights: torch.Tensor  # LTS: 1 below the cutoff, a/b at it, 0 above
    # per-concentration-step selection sweep counts, (c_steps, n_starts)
    # int32 (None where the fit has no iterative selection): steady state
    # is 1 sweep a step on warm fits
    sweeps: Optional[torch.Tensor] = None


def _generator(key, device) -> torch.Generator:
    """``key`` as a ``torch.Generator`` on ``device``: a generator is used
    as it is, an int seeds a new one."""
    if isinstance(key, torch.Generator):
        return key
    gen = torch.Generator(device=device)
    gen.manual_seed(int(key))
    return gen


def _elemental_thetas(key, X, y, n_starts):
    """Solve p x p systems on random p-subsets (PROGRESS-style starts).

    Each start's subset is drawn without replacement by Floyd's algorithm
    (p draws a start, all starts at once) from ``key``, a
    ``torch.Generator`` on X's device or an int seed; the systems are one
    batched ridge-regularized solve."""
    n, p = X.shape
    gen = _generator(key, X.device)
    idx = torch.empty((n_starts, p), dtype=torch.int64, device=X.device)
    for i, j in enumerate(range(n - p, n)):
        t = torch.randint(0, j + 1, (n_starts,), generator=gen,
                          device=X.device)
        dup = (idx[:, :i] == t[:, None]).any(dim=1)
        idx[:, i] = torch.where(dup, j, t)
    A, b = X[idx], y[idx]                              # (S, p, p), (S, p)
    At = A.transpose(1, 2)
    G = At @ A + 1e-8 * torch.eye(p, dtype=X.dtype, device=X.device)
    return torch.linalg.solve(G, (At @ b[..., None])[..., 0])


def _lts_weights(r, h):
    """Fractional trimming weights: 1 / (a/b) / 0 per the paper's rho."""
    return _lts_weights_rows(r[None, :], h)[0][0]


def _lts_weights_rows(R, h, method=None, prior=None):
    """Row-wise fractional trimming weights for (B, n) residual blocks.

    One rows-mode selection gives every row's cutoff m = r^2_(h); ties at
    the cutoff get weight a/b, so each row keeps EXACTLY h points in total
    weight.  ``prior`` warm-starts the cutoff selection from the previous
    concentration step.  Returns ``(weights, SelectResult)``."""
    a2 = R * R
    res = selection.select_rows(a2, h, method=method, prior=prior)
    m = res.value[:, None]
    b_lo = torch.sum(a2 < m, dim=1, keepdim=True, dtype=torch.int32)
    b_eq = torch.sum(a2 == m, dim=1, keepdim=True, dtype=torch.int32)
    frac = (h - b_lo).to(a2.dtype) / torch.clamp(b_eq, min=1).to(a2.dtype)
    return torch.where(a2 < m, 1.0, torch.where(a2 == m, frac, 0.0)), res


def _carry_prior(res, shape, pdt) -> selection.Prior:
    """A result as the next step's prior, each field in ``pdt`` broadcast
    to ``shape`` (a cp-leg and a binned-leg result give the same carry)."""
    return selection.Prior(*(torch.as_tensor(f).to(pdt).broadcast_to(shape)
                             for f in selection.as_prior(res)))


def _nan_prior(shape, pdt, device=None) -> selection.Prior:
    """Cold-start carry: all-NaN fields are sanitized away inside the
    engine (a NaN prior degrades to the uniform layout), so the first step
    of a warm fit solves as a cold one does, with the same sweeps."""
    nanv = torch.full(shape, float("nan"), dtype=pdt, device=device)
    return selection.Prior(nanv, nanv, nanv, nanv)


def _weighted_ls(X, y, w):
    Xw = X * w[:, None]
    G = X.T @ Xw + 1e-8 * torch.eye(X.shape[1], dtype=X.dtype,
                                    device=X.device)
    return torch.linalg.solve(G, Xw.T @ y)


def _weighted_ls_rows(X, y, W):
    """Batched weighted LS: ``W`` is (B, n) weights, one (p, p) system a
    row.  Each row's normal matrix is ``W @ (x_i x_j)`` over the (n, p*p)
    products of X's columns, so no (B, n, p) tensor is made; the B systems
    are one batched solve."""
    n, p = X.shape
    XX = (X[:, :, None] * X[:, None, :]).reshape(n, p * p)
    G = (W @ XX).reshape(-1, p, p) + 1e-8 * torch.eye(p, dtype=X.dtype,
                                                      device=X.device)
    return torch.linalg.solve(G, W @ (X * y[:, None]))


def _concentrate(thetas0, X, y, hh, c_steps, method, warm) -> RobustFit:
    """FAST-LTS concentration from the starts ``thetas0`` (n_starts, p):
    ``c_steps`` steps, each one rows-mode selection of every start's cutoff
    (warm: the previous step's result as its prior) and one batched
    weighted refit; then the best start by the LTS objective."""
    n_starts = thetas0.shape[0]
    pdt = torch.promote_types(X.dtype, torch.float32)
    thetas = thetas0
    pr = _nan_prior((n_starts,), pdt, X.device)
    sweeps = []
    for _ in range(c_steps):
        R = thetas @ X.T - y[None, :]          # (n_starts, n) residuals
        W, res = _lts_weights_rows(R, hh, method, prior=pr if warm else None)
        pr = _carry_prior(res, (n_starts,), pdt)
        thetas = _weighted_ls_rows(X, y, W)
        sweeps.append(res.iters)
    objs = lts_objective_rows(thetas @ X.T - y[None, :], hh, method=method,
                              prior=pr if warm else None)
    best = torch.argmin(objs)
    theta = thetas[best]
    return RobustFit(
        theta=theta,
        objective=objs[best],
        inlier_weights=_lts_weights(residuals(theta, X, y), hh),
        sweeps=(torch.stack(sweeps) if sweeps else torch.zeros(
            (0, n_starts), dtype=torch.int32, device=X.device)),
    )


def lts_fit(key, X, y, *, h: Optional[int] = None, n_starts: int = 64,
            c_steps: int = 10, method: Optional[str] = None,
            warm: bool = True) -> RobustFit:
    """FAST-LTS: elemental starts -> concentration steps -> best fit.

    ``key`` (a ``torch.Generator`` on X's device, or an int seed) draws the
    ``n_starts`` elemental starts; concentration runs starts-inside,
    steps-outside: each step thresholds ALL starts' squared residuals at
    their h-th order statistic in ONE rows-mode selection (no sort), then
    refits every start by weighted LS.  The objective is non-increasing
    along the steps, so the best of the starts is a high-breakdown
    estimate.  ``method`` threads through to the selections (None: auto).

    ``warm`` (default): each step's selection takes the previous step's
    result as its prior, so steady-state steps take one binned sweep; the
    results equal ``warm=False``'s bit for bit (the prior places edges
    only) and ``RobustFit.sweeps`` records the sweeps a step.
    """
    n, p = X.shape
    hh = (n + p + 1) // 2 if h is None else h
    thetas0 = _elemental_thetas(key, X, y, n_starts)
    return _concentrate(thetas0, X, y, hh, c_steps, method, warm)


def _lms_from_starts(thetas, X, y, method) -> RobustFit:
    """LMS as the best of the starts ``thetas`` (n_starts, p): every start's
    Med(r^2) is one row of a single rows-mode selection."""
    n = X.shape[0]
    R2 = (thetas @ X.T - y[None, :]) ** 2      # (n_starts, n)
    objs = selection.select_rows(R2, (n + 1) // 2, method=method).value
    best = torch.argmin(objs)
    theta = thetas[best]
    r2 = residuals(theta, X, y) ** 2
    med = selection.median(r2, method=method).value
    return RobustFit(theta=theta, objective=objs[best],
                     inlier_weights=(r2 <= med).to(X.dtype))


def lms_fit(key, X, y, *, n_starts: int = 256,
            method: Optional[str] = None) -> RobustFit:
    """LMS by the best of ``n_starts`` elemental starts (the classical
    PROGRESS approach), drawn from ``key`` as in :func:`lts_fit`: thousands
    of concurrent selection problems in one bracket loop, the workload the
    paper's method targets."""
    return _lms_from_starts(_elemental_thetas(key, X, y, n_starts), X, y,
                            method)


# ---------------------------------------------------------------------------
# Weighted-median regression: Theil-Sen and IRLS M-estimation
# ---------------------------------------------------------------------------


class TheilSenFit(NamedTuple):
    intercept: torch.Tensor
    slope: torch.Tensor
    theta: torch.Tensor        # (2,) = [intercept, slope]
    # (slope Prior, intercept Prior) carry for warm refits; pass the whole
    # fit back as ``prior=`` to the next call
    prior: object = None


def _pair_offsets(n: int, max_pairs: int) -> np.ndarray:
    """The blocked Theil-Sen schedule: ``max_pairs // n`` cyclic offsets
    (at least 1, at most n - 1) spread evenly over ``1 .. n-1``."""
    p = int(max(1, min(n - 1, max_pairs // n)))
    return np.unique(np.round(np.linspace(1, n - 1, p)).astype(np.int64))


def _as_fit_priors(prior):
    """(slope prior, intercept prior) from a previous :class:`TheilSenFit`
    (its carry, else its point estimates) or an explicit pair."""
    if prior is None:
        return None, None
    if isinstance(prior, TheilSenFit):
        spr, ipr = (prior.prior if prior.prior is not None
                    else (prior.slope, prior.intercept))
    else:
        spr, ipr = prior
    return selection.as_prior(spr), selection.as_prior(ipr)


def theil_sen_fit(x, y, *, weighting: str = "sen",
                  method: Optional[str] = None,
                  max_pairs: Optional[int] = None,
                  prior=None) -> TheilSenFit:
    """Theil-Sen simple regression by the weighted median of pairwise
    slopes.

    All pairwise slopes ride ONE weighted selection (pairs with
    ``x_i == x_j`` get weight 0); ``weighting='sen'`` weights each slope by
    ``|x_j - x_i|`` (Sen 1968), ``'uniform'`` gives the classical median of
    slopes.  The intercept is the median of the residuals at the slope.

    ``max_pairs=None`` forms the full (n, n) slope matrix.  Otherwise, when
    ``max_pairs < n*n``, slopes come in a BLOCKED offset layout: ``p =
    max_pairs // n`` cyclic offsets ``d`` spread over ``1 .. n-1`` pair
    every ``x_i`` with ``x_{(i+d) mod n}`` into a (p, n) block, O(max_pairs)
    memory; with ``max_pairs = n*(n-1)`` the offsets take every ordered
    pair once, the (slope, weight) multiset of the full matrix, so both
    modes agree.  ``prior``: a previous fit or a (slope, intercept) pair of
    priors, each in any form ``selection.as_prior`` takes; the results do
    not depend on it.
    """
    x = torch.as_tensor(x).reshape(-1)
    y = torch.as_tensor(y, device=x.device).reshape(-1)
    n = x.shape[0]
    if max_pairs is not None and n > 2 and max_pairs < n * n:
        offsets = torch.as_tensor(_pair_offsets(n, max_pairs),
                                  device=x.device)
        idx = (torch.arange(n, device=x.device)[None, :]
               + offsets[:, None]) % n                         # (p, n)
        dx = x[idx] - x[None, :]
        dy = y[idx] - y[None, :]
    else:
        dx = x[None, :] - x[:, None]
        dy = y[None, :] - y[:, None]
    valid = dx != 0
    slopes = torch.where(valid, dy / torch.where(valid, dx, 1.0), 0.0)
    if weighting == "sen":
        w = torch.where(valid, torch.abs(dx), 0.0)
    elif weighting == "uniform":
        w = valid.to(x.dtype)
    else:
        raise ValueError(f"unknown weighting {weighting!r}")
    spr, ipr = _as_fit_priors(prior)
    sres = selection.weighted_median(slopes.reshape(-1), w.reshape(-1),
                                     method=method, prior=spr)
    slope = sres.value
    # y - slope*x with one rounding, as the reference's compiled code
    # forms it (a fused multiply-add)
    ires = selection.median(selection._fma(-slope, x, y), method=method,
                            prior=ipr)
    intercept = ires.value
    return TheilSenFit(intercept=intercept, slope=slope,
                       theta=torch.stack([intercept, slope]),
                       prior=(selection.as_prior(sres),
                              selection.as_prior(ires)))


class IRLSFit(NamedTuple):
    theta: torch.Tensor
    scale: torch.Tensor       # final robust scale (weighted MAD estimate)
    weights: torch.Tensor     # final robustness weights (n,)
    objective: torch.Tensor   # sum of rho(r / scale) at the final iterate
    # per-iteration weighted-median sweep counts, (iters,) int32: steady
    # state is 1 sweep an iteration on warm fits
    sweeps: Optional[torch.Tensor] = None


def _rho_weights(u, loss: str, c):
    """IRLS weight function w(u) = psi(u)/u for the supported losses."""
    au = torch.abs(u)
    if loss == "huber":
        return torch.clamp(c / torch.clamp(au, min=1e-20), max=1.0)
    if loss == "tukey":
        t = torch.clamp(1.0 - (u / c) ** 2, min=0.0)
        return t * t
    raise ValueError(f"unknown loss {loss!r}")


def _rho(u, loss: str, c):
    au = torch.abs(u)
    if loss == "huber":
        return torch.where(au <= c, 0.5 * u * u, c * au - 0.5 * c * c)
    # tukey bisquare
    t = torch.clamp(1.0 - (u / c) ** 2, min=0.0)
    return (c * c / 6.0) * (1.0 - t ** 3)


def irls_fit(X, y, *, loss: str = "huber", c: Optional[float] = None,
             iters: int = 30, method: Optional[str] = None,
             min_scale: float = 1e-12, warm: bool = True) -> IRLSFit:
    """IRLS M-estimator (Huber / Tukey bisquare) with a weighted-engine
    scale step.

    Each iteration's scale is a weighted MAD about zero: 1.4826 x the
    weighted median of |residuals| under the current robustness weights
    (one weighted selection), so down-weighted outliers stop corrupting
    their own threshold; then the w(u) = psi(u)/u reweighting and a
    weighted LS refit.  ``c`` defaults to the 95%-efficiency constants
    (Huber 1.345, Tukey 4.685).  ``warm`` (default): each iteration's
    weighted median takes the previous one's result as its prior
    (bit-identical results; ``IRLSFit.sweeps`` records the sweeps)."""
    if c is None:
        c = 1.345 if loss == "huber" else 4.685
    n = X.shape[0]
    pdt = torch.promote_types(X.dtype, torch.float32)
    w = torch.ones((n,), dtype=X.dtype, device=X.device)
    theta = _weighted_ls(X, y, w)
    pr = _nan_prior((), pdt, X.device)
    sweeps = []
    for _ in range(iters):
        r = y - X @ theta
        res = selection.weighted_median(torch.abs(r), w, method=method,
                                        prior=pr if warm else None)
        sigma = torch.clamp(1.4826 * res.value, min=min_scale)
        w = _rho_weights(r / sigma, loss, c)
        theta = _weighted_ls(X, y, w)
        pr = _carry_prior(res, (), pdt)
        sweeps.append(res.iters)
    # scale, weights and objective re-measured AT the returned theta (the
    # loop's sigma was measured on the residuals before the last refit)
    r = y - X @ theta
    mad = selection.weighted_median(torch.abs(r), w, method=method,
                                    prior=pr if warm else None).value
    scale = torch.clamp(1.4826 * mad, min=min_scale)
    u = r / scale
    return IRLSFit(theta=theta, scale=scale, weights=_rho_weights(u, loss, c),
                   objective=torch.sum(_rho(u, loss, c)),
                   sweeps=(torch.stack(sweeps) if sweeps else torch.zeros(
                       (0,), dtype=torch.int32, device=X.device)))


def knn_predict(train_x, train_y, query_x, k: int, *, classify: bool = False,
                n_classes: int = 0, method: Optional[str] = None):
    """kNN regression/classification without sorting the distances.

    Squared distances by one matmul; the k-NN cutoffs of ALL queries from
    one rows-mode selection over the (Q, n) distance matrix; ties at the
    cutoff get fractional weight, so exactly k neighbours count."""
    d2 = (torch.sum(query_x ** 2, -1, keepdim=True)
          - 2.0 * query_x @ train_x.T
          + torch.sum(train_x ** 2, -1)[None, :])
    dk = selection.select_rows(d2, k, method=method).value[:, None]
    lt = (d2 < dk).to(d2.dtype)
    eq = (d2 == dk).to(d2.dtype)
    n_lt = torch.sum(lt, -1, keepdim=True)
    n_eq = torch.sum(eq, -1, keepdim=True)
    frac = (k - n_lt) / torch.clamp(n_eq, min=1.0)
    w = lt + eq * frac  # sums to exactly k per query
    if classify:
        onehot = torch.nn.functional.one_hot(
            torch.as_tensor(train_y).to(torch.int64), n_classes).to(d2.dtype)
        return torch.argmax(w @ onehot, -1)
    return (w @ train_y.to(d2.dtype)) / k


# ---------------------------------------------------------------------------
# Gradient pytrees: quantile thresholds and clipping
# ---------------------------------------------------------------------------


def _tree_flatten(tree):
    """Leaves of nested dicts, lists and tuples (named tuples included), in
    ``jax.tree``'s order: dict keys sorted, sequences in order; ``None`` is
    an empty subtree.  Returns ``(leaves, spec)`` for
    :func:`_tree_unflatten`."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_tree_flatten(tree[k]) for k in keys]
        return ([leaf for p in parts for leaf in p[0]],
                ("dict", keys, [p[1] for p in parts]))
    if isinstance(tree, (list, tuple)):
        parts = [_tree_flatten(v) for v in tree]
        return ([leaf for p in parts for leaf in p[0]],
                (type(tree), None, [p[1] for p in parts]))
    return [tree], "leaf"


def _tree_unflatten(spec, leaves):
    """Inverse of :func:`_tree_flatten`: ``leaves`` (in its order) placed
    into the structure ``spec``."""
    it = iter(leaves)

    def build(sp):
        if sp is None:
            return None
        if sp == "leaf":
            return next(it)
        kind, keys, subs = sp
        vals = [build(s) for s in subs]
        if kind == "dict":
            return dict(zip(keys, vals))
        if hasattr(kind, "_fields"):  # a named tuple
            return kind(*vals)
        return kind(vals)

    return build(spec)


def _tree_map(fn, *trees):
    leaves = [_tree_flatten(t)[0] for t in trees]
    spec = _tree_flatten(trees[0])[1]
    return _tree_unflatten(spec, [fn(*ls) for ls in zip(*leaves)])


def _absf(leaf, abs_values: bool):
    leaf = torch.as_tensor(leaf).to(torch.float32)
    return torch.abs(leaf) if abs_values else leaf


def pytree_quantile(tree, q, *, maxit: int = 16, abs_values: bool = True):
    """Approximate global q-quantile over all entries of a pytree (|x| by
    default): the cutting-plane loop with the pytree as one logical array,
    each iteration one pass over every leaf (their partials added).
    Counts are f32 (pytrees pass 2^31 entries), as in the reference.

    Returns the bracket midpoint on a non-exact exit (tight after ~16
    iterations for clipping), the exact value on an exact hit."""
    leaves = [_absf(leaf, abs_values) for leaf in _tree_flatten(tree)[0]]
    n = sum(leaf.numel() for leaf in leaves)
    dev = leaves[0].device
    f32 = torch.float32
    nf = torch.tensor(float(n), dtype=f32, device=dev)
    k = torch.clamp(torch.ceil(torch.tensor(q, dtype=f32, device=dev) * nf),
                    1.0, nf)

    def partials(y):
        sp = sn = lt = le = torch.zeros((), dtype=f32, device=dev)
        for leaf in leaves:
            d = leaf - y
            sp = sp + torch.sum(torch.clamp(d, min=0))
            sn = sn + torch.sum(torch.clamp(-d, min=0))
            lt = lt + torch.sum(d < 0, dtype=f32)
            le = le + torch.sum(d <= 0, dtype=f32)
        return sp, sn, lt, le

    xmin = torch.stack([torch.amin(leaf) for leaf in leaves]).amin()
    xmax = torch.stack([torch.amax(leaf) for leaf in leaves]).amax()
    xsum = torch.zeros((), dtype=f32, device=dev)
    for leaf in leaves:
        xsum = xsum + torch.sum(leaf)
    alpha = (nf - k + 0.5) / nf
    beta = (k - 0.5) / nf
    yL, fL = xmin, beta * (xsum / nf - xmin)
    gL = alpha / nf - beta * (nf - 1.0) / nf
    yR, fR = xmax, alpha * (xmax - xsum / nf)
    gR = alpha * (nf - 1.0) / nf - beta / nf
    t = 0.5 * (xmin + xmax)
    exact = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(maxit):
        if bool(exact) or not bool(yR > yL):
            break
        t = (fR - fL + yL * gL - yR * gR) / (gL - gR)
        bad = ~torch.isfinite(t) | (t <= yL) | (t >= yR)
        t = torch.where(bad, 0.5 * (yL + yR), t)
        fg = fg_from_partials(partials(t), n, k)
        ex = (fg.n_lt < k) & (k <= fg.n_le)
        move_left = fg.g_hi < 0
        yL, fL, gL = (torch.where(move_left, t, yL),
                      torch.where(move_left, fg.f, fL),
                      torch.where(move_left, fg.g_hi, gL))
        keep_r = move_left | ex
        yR, fR, gR = (torch.where(keep_r, yR, t),
                      torch.where(keep_r, fR, fg.f),
                      torch.where(keep_r, gR, fg.g_lo))
        exact = exact | ex
    return torch.where(exact, t, 0.5 * (yL + yR))


def pytree_quantile_per_leaf(tree, q, *, abs_values: bool = True,
                             method: Optional[str] = None,
                             maxit: int = 64):
    """EXACT per-leaf q-quantiles of a pytree in ONE segmented solve.

    The leaves (|leaf| by default, in f32) are concatenated with a leaf-id
    segment vector (already sorted, so the solve makes no sort) and the
    per-leaf ranks resolve on the host at f64
    (``selection.segmented_quantiles``): every data pass is shared by all
    leaves.  Returns a pytree of the same structure with one scalar
    threshold a leaf."""
    leaves, spec = _tree_flatten(tree)
    if not leaves:
        return tree
    sizes = [int(torch.as_tensor(leaf).numel()) for leaf in leaves]
    x = torch.cat([_absf(leaf, abs_values).reshape(-1) for leaf in leaves])
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=x.device),
        torch.as_tensor(sizes, device=x.device))
    res = selection.segmented_quantiles(x, seg, q, sizes, method=method,
                                        maxit=maxit)
    return _tree_unflatten(spec, list(res.value.unbind(0)))


def hist_quantile(tree, q, *, bins: int = 512, abs_values: bool = True):
    """Two-pass histogram quantile over a pytree (|x| by default),
    APPROXIMATE to a bin: pass 1 the min and max, pass 2 one ``bins``-bin
    log-spaced histogram (integer counts); the quantile is the upper edge
    of the first bin whose cumulative count reaches ``q * n``.  For exact
    thresholds use :func:`pytree_quantile_per_leaf`."""
    leaves = [_absf(leaf, abs_values) for leaf in _tree_flatten(tree)[0]]
    n = sum(leaf.numel() for leaf in leaves)
    lo = torch.stack([torch.amin(leaf) for leaf in leaves]).amin()
    hi = torch.stack([torch.amax(leaf) for leaf in leaves]).amax()
    lo = torch.clamp(lo, min=1e-12)
    hi = torch.maximum(hi, lo * (1 + 1e-6))
    llo, lhi = torch.log(lo), torch.log(hi)
    scale = (bins - 1) / torch.clamp(lhi - llo, min=1e-12)
    hist = torch.zeros((bins,), dtype=torch.int64, device=lo.device)
    for leaf in leaves:
        v = torch.clamp(torch.log(torch.clamp(leaf, min=1e-12)), llo, lhi)
        idx = ((v - llo) * scale).to(torch.int64).reshape(-1)
        hist += torch.bincount(torch.clamp(idx, 0, bins - 1),
                               minlength=bins)
    cum = torch.cumsum(hist, 0)
    k = float(np.float32(q) * np.float32(n))
    bin_idx = torch.argmax((cum.to(torch.float64) >= k).to(torch.int32))
    # upper edge of the bin (conservative for clipping)
    return torch.exp(llo + (bin_idx.to(torch.float32) + 1.0) / scale)


def clip_by_quantile(tree, q: float = 0.99, *, maxit: int = 16,
                     min_scale: float = 1e-8, per_leaf: bool = False):
    """Clip gradient magnitudes at their q-quantile (an alternative to
    global-norm clipping, robust to exploding coordinates).

    ``per_leaf=False`` (default): ONE global threshold from
    :func:`pytree_quantile`; returns ``(clipped_tree, threshold)``.
    ``per_leaf=True``: every leaf clipped at its own exact q-quantile, all
    from one segmented solve (:func:`pytree_quantile_per_leaf`); returns
    ``(clipped_tree, thresholds_tree)``, one scalar a leaf."""
    if per_leaf:
        thrs = _tree_map(lambda t: torch.clamp(t, min=min_scale),
                         pytree_quantile_per_leaf(tree, q))
        clipped = _tree_map(
            lambda g, t: torch.clamp(g, -t.to(g.dtype), t.to(g.dtype)),
            tree, thrs)
        return clipped, thrs
    thr = torch.clamp(pytree_quantile(tree, q, maxit=maxit), min=min_scale)
    clipped = _tree_map(
        lambda g: torch.clamp(g, -thr.to(g.dtype), thr.to(g.dtype)), tree)
    return clipped, thr
