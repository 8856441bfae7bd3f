"""The port's binned polish and warm starts held against the JAX reference.

Same numpy inputs through ``repro`` (jnp backend, jitted, as its own tests
run it on the CPU) and the port on the CPU (``device="cpu"``):

* the realized edges of a polish sweep (``polish_edges``) and of a warm
  first sweep (``prior_edges``), bit for bit against the reference's
  jitted functions; denormal brackets are held to the edge contract only,
  because the jitted reference flushes denormals (ROADMAP Queue 3);
* the per-slot sums of the six plain histograms (``want_sums=True``, the
  input of the polish) against the reference's oracles;
* ``method='binned_polish'`` on exactly summable data (integer x and w,
  totals below 2^24, so every sum is exact in any order): every field of
  the result equals the reference's; on randn, bf16 and tie-storm data the
  value equals the reference's and ``np.partition``'s;
* ``prior=`` warm starts, with a prior the reference made, handed to the
  port through ``convert.prior_from_numpy``; the stream helpers; and the
  no-``(K, n)`` guarantee of the polished multi-k pass.

Few distinct shapes, so the reference jits few times.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import (from_numpy, prior_from_numpy,  # noqa: E402
                                 select_result_from_numpy)
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.core import stream as tstream  # noqa: E402
from repro_torch.kernels import cp_objective  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs its files in parallel processes: one intra-op thread
    per process keeps torch's many small ops from contending with the
    other processes' threads (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


N = 1 << 16          # the binned leg (n >= BINNED_MIN_N), one jit shape
FIELDS = ("value", "iters", "status", "y_lo", "y_hi", "n_in")
TINY = np.finfo(np.float32).tiny
ONE_UP = float(np.nextafter(np.float32(0.25), np.float32(1)))

_jit_polish = jax.jit(jsel.polish_edges, static_argnums=3)
_jit_prior = jax.jit(jsel.prior_edges, static_argnums=3)


def _t(a):
    return from_numpy(np.ascontiguousarray(a), device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_result(got, ref):
    """Every field equal, bit for bit, dtype included."""
    want = select_result_from_numpy(
        type(ref)(*(np.asarray(f) for f in ref)), device="cpu")
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()),
                                      err_msg=name)


def _port_prior(prior):
    """A reference prior (or result) handed to the port."""
    return prior_from_numpy(type(prior)(*(np.asarray(f) for f in prior)),
                            device="cpu")


def _ints(seed, shape, lo=-300, hi=300):
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(
        np.float32)


def kth(x, k):
    return np.partition(np.asarray(x), k - 1)[k - 1]


# ---------------------------------------------------------------------------
# realized edges: polish_edges and prior_edges
# ---------------------------------------------------------------------------

# brackets at data scale, narrow, full f32 range and one ulp wide
# (duplicated edges), each row meeting every kind of cut in turn; none is
# centred on 0.0, whose prev_float is a denormal that the jitted reference
# flushes (a prior value of 0.0 belongs to the denormal regime)
BRACKETS = [(-2.0, 3.0), (0.25, 0.25 + 1e-5), (-3e38, 2e38), (0.25, ONE_UP)]


def _cuts(lo, hi):
    """Cuts: NaN, ±inf, outside the bracket, on each endpoint, inside."""
    return [np.nan, np.inf, -np.inf, hi + (hi - lo) + 1.0, lo, hi,
            lo + 0.3 * (hi - lo)]


def _bracket_rows():
    lo, hi, cut = [], [], []
    for a, b in BRACKETS:
        for c in _cuts(np.float64(a), np.float64(b)):
            lo.append(a), hi.append(b), cut.append(c)
    f = lambda v: np.clip(v, -3.4e38, 3.4e38).astype(np.float32)  # noqa
    return f(lo), f(hi), f(cut)


@pytest.mark.parametrize("nbins", [128, 100, 3])
def test_polish_edges_bits_match_reference(nbins):
    lo, hi, cut = _bracket_rows()
    got = tsel.polish_edges(_t(lo), _t(hi), _t(cut), nbins).numpy()
    want = np.asarray(_jit_polish(jnp.asarray(lo), jnp.asarray(hi),
                                  jnp.asarray(cut), nbins))
    assert got.shape == (lo.size, nbins + 1)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nbins", [128, 100, 3])
def test_prior_edges_bits_match_reference(nbins):
    """Priors: inside, NaN value, infinite bracket, inverted bracket, a
    bracket excluding the interval, zero width, on an endpoint."""
    lo, hi, cut = _bracket_rows()
    span = hi.astype(np.float64) - lo.astype(np.float64)
    mid = (lo.astype(np.float64) + 0.5 * span).astype(np.float32)
    kinds = np.arange(lo.size) % 7
    value = np.where(kinds == 1, np.nan, np.where(kinds == 6, lo, mid))
    y_lo = np.select([kinds == 2, kinds == 3, kinds == 4],
                     [-np.inf, mid + 1, hi + 5], mid - span / 8)
    y_hi = np.select([kinds == 2, kinds == 3, kinds == 4, kinds == 5],
                     [np.inf, mid - 1, hi + 6, mid], mid + span / 8)
    f32 = lambda v: np.asarray(v, np.float64).astype(np.float32)  # noqa
    prior = tuple(f32(v) for v in (value, y_lo, y_hi, cut))
    got = tsel.prior_edges(_t(lo), _t(hi), tsel.Prior(*map(_t, prior)),
                           nbins).numpy()
    want = np.asarray(_jit_prior(jnp.asarray(lo), jnp.asarray(hi),
                                 jsel.Prior(*map(jnp.asarray, prior)),
                                 nbins))
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_denormal_brackets_keep_the_edge_contract():
    """Value only: the jitted reference flushes denormals, the port does
    not, so denormal brackets are held to the contract — sorted, inside
    the bracket, ends pinned, denormals kept."""
    lo = np.array([-1e-40, 0.0, 1e-45, -1e-38], np.float32)
    hi = np.array([1e-40, 1e-41, 1e-44, 1e-38], np.float32)
    cut = np.array([0.0, np.nan, 5e-45, 1e-39], np.float32)
    v = tsel.Prior(*map(_t, (cut, lo, hi, cut)))
    for e in (tsel.polish_edges(_t(lo), _t(hi), _t(cut), 16),
              tsel.prior_edges(_t(lo), _t(hi), v, 16)):
        e = e.numpy()
        assert np.all(e[:, 1:] >= e[:, :-1])
        np.testing.assert_array_equal(_bits(e[:, 0]), _bits(lo))
        np.testing.assert_array_equal(_bits(e[:, -1]), _bits(hi))
        assert np.all((e >= lo[:, None]) & (e <= hi[:, None]))
        assert np.any((e != 0) & (np.abs(e) < TINY))


# ---------------------------------------------------------------------------
# the per-slot sums of the six plain histograms
# ---------------------------------------------------------------------------


_jit_hist = {}


def _hist_case(kind, weighted, x, w, edges):
    """(port, reference) outputs of one plain histogram with sums; one
    jitted reference per histogram, shared by the integer and randn
    inputs."""
    name = ("w" if weighted else "") + "cp_histogram" + kind + "_ref"
    jf = _jit_hist.get(name)
    if jf is None:
        jf = _jit_hist[name] = jax.jit(functools.partial(
            getattr(jref, name), impl="searchsorted"))
    args = (x, w, edges) if weighted else (x, edges)
    got = getattr(tref, name)(*map(_t, args), want_sums=True)
    return got, [np.asarray(v) for v in jf(*map(jnp.asarray, args))]


def _hist_inputs(kind, integer):
    rng = np.random.default_rng(5)
    shape = {"_batched": (3, 4099), "_multi": (4099,), "": (4099,)}[kind]
    x = (rng.integers(-40, 40, shape).astype(np.float32) if integer
         else rng.standard_normal(shape).astype(np.float32))
    x[..., :3] = [np.nan, -np.inf, np.inf]
    w = rng.integers(0, 4, shape).astype(np.float32)
    w[..., :3] = 1.0  # (a zero weight on +-inf would make its w*x NaN)
    lo = np.array([-30.0, -3e38, 0.25], np.float32)
    hi = np.array([30.0, 3e38, ONE_UP], np.float32)
    edges = tref.bin_edges(_t(lo), _t(hi), 16).numpy()
    return x, w, edges[0] if kind == "" else edges


@pytest.mark.parametrize("kind", ["_batched", "_multi", ""])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("integer", [True, False])
def test_plain_sums_match_reference(kind, weighted, integer):
    """Integer data: counts, masses and sums bit for bit (a NaN makes the
    top slot's sum NaN, -inf slot 0's); randn: the sums within the
    rounding of 4099-term f32 chains in either order."""
    x, w, edges = _hist_inputs(kind, integer)
    got, want = _hist_case(kind, weighted, x, w, edges)
    assert len(got) == len(want) and got[-1] is not None
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    top = got[-1].numpy()[..., -1]
    assert np.all(np.isnan(top)) and np.all(np.isneginf(
        got[-1].numpy()[..., 0][np.asarray(edges)[..., 0] > -1e38]))
    for g, v in zip(got[1:], want[1:]):
        g = g.numpy()
        if integer:
            np.testing.assert_array_equal(_bits(g), _bits(v))
        else:
            fin = np.isfinite(v)
            np.testing.assert_array_equal(np.isfinite(g), fin)
            np.testing.assert_allclose(g[fin], v[fin], rtol=0,
                                       atol=4099 * 2.0 ** -24 * 4 * 3 * 4)


# ---------------------------------------------------------------------------
# binned_polish against the reference
# ---------------------------------------------------------------------------


def test_polish_exact_data_scalar_and_rows():
    """Integer x: the sums are exact in any order, so every field of the
    polished result equals the reference's (on the CPU: no kernel runs)."""
    cp_objective.reset_launches()
    x = _ints(10, N)
    for k in (1, 77, N // 3, (N + 1) // 2, N):
        got = tsel.order_statistic(_t(x), k, method="binned_polish")
        ref = jsel.order_statistic(jnp.asarray(x), k, method="binned_polish",
                                   backend="jnp")
        assert_same_result(got, ref)
        assert got.value.item() == kth(x, k)
    xr = _ints(11, (4, N))
    ks = np.array([1, 999, N // 2, N], np.int32)
    got = tsel.select_rows(_t(xr), _t(ks), method="binned_polish")
    assert_same_result(got, jsel.select_rows(
        jnp.asarray(xr), jnp.asarray(ks), method="binned_polish",
        backend="jnp"))
    assert not any(cp_objective.LAUNCHES.values())


def test_polish_exact_data_multi_k():
    x = _ints(12, N)
    ks = np.array([1, 100, N // 4, N // 2, N - 3], np.int32)
    got = tsel.multi_order_statistic(_t(x), _t(ks), method="binned_polish")
    assert_same_result(got, jsel.multi_order_statistic(
        jnp.asarray(x), jnp.asarray(ks), method="binned_polish",
        backend="jnp"))
    np.testing.assert_array_equal(got.value.numpy(),
                                  [kth(x, int(k)) for k in ks])


def test_polish_exact_data_weighted():
    """Integer weights 0..4: masses and Σw·x exact, every field equal to
    the reference's (rows and shared x; the scalar entry point is the B = 1
    view of the rows one, held to it and to the sorted-cumsum oracle)."""
    rng = np.random.default_rng(13)
    xr, wr = _ints(14, (4, N)), rng.integers(0, 5, (4, N)).astype(np.float32)
    wks = (wr.sum(1) * np.array([0.01, 0.3, 0.5, 0.99])).astype(np.float32)
    assert_same_result(
        tsel.weighted_select_rows(_t(xr), _t(wr), _t(wks),
                                  method="binned_polish"),
        jsel.weighted_select_rows(jnp.asarray(xr), jnp.asarray(wr),
                                  jnp.asarray(wks), method="binned_polish",
                                  backend="jnp"))
    x, w = xr[1], wr[1]
    for wk in (np.float32(1.0), wks[1], wks[3]):
        got = tsel.weighted_order_statistic(_t(x), _t(w), wk,
                                            method="binned_polish")
        row = tsel.weighted_select_rows(
            _t(x[None]), _t(w[None]), _t(wk[None]), method="binned_polish",
            cap=tsel._default_cap(N))
        for name in FIELDS:
            assert torch.equal(getattr(got, name), getattr(row, name)[0])
        o = np.argsort(x, kind="stable")
        c = np.cumsum(w[o].astype(np.float64))
        assert got.value.item() == x[o][np.searchsorted(c, wk)]
    wks = np.array([1.0, w.sum() * 0.3, w.sum() * 0.7], np.float32)
    assert_same_result(
        tsel.weighted_multi_order_statistic(_t(x), _t(w), _t(wks),
                                            method="binned_polish"),
        jsel.weighted_multi_order_statistic(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(wks),
            method="binned_polish", backend="jnp"))


def _regime(name):
    rng = np.random.default_rng(20)
    if name == "randn":
        return rng.standard_normal(N).astype(np.float32)
    if name == "tie_storm":
        return rng.integers(-3, 4, N).astype(np.float32) * np.float32(0.5)
    return rng.lognormal(0, 4, N).astype(np.float32)  # heavy tail


@pytest.mark.parametrize("regime", ["randn", "tie_storm", "lognormal"])
def test_polish_values_and_sweeps(regime):
    """Sums in another order than the reference's: the value equals the
    reference's and np.partition's, the status the reference's, and the
    polish never takes more sweeps than plain 'binned'."""
    x = _regime(regime)
    for k in (7, N // 3, (N + 1) // 2):
        got = tsel.order_statistic(_t(x), k, method="binned_polish")
        ref = jsel.order_statistic(jnp.asarray(x), k, method="binned_polish",
                                   backend="jnp")
        plain = tsel.order_statistic(_t(x), k, method="binned")
        assert got.value.item() == np.asarray(ref.value) == kth(x, k)
        assert int(got.status) == int(ref.status) != tsel.NOT_CONVERGED
        assert int(got.iters) <= int(plain.iters)


def test_polish_bf16_values():
    x = _regime("randn")
    xb = _t(x).to(torch.bfloat16)
    xf = xb.float().numpy()
    for k in (7, (N + 1) // 2):
        got = tsel.order_statistic(xb, k, method="binned_polish")
        ref = jsel.order_statistic(jnp.asarray(x, jnp.bfloat16), k,
                                   method="binned_polish", backend="jnp")
        assert got.value.float().item() == float(ref.value) == kth(xf, k)
        assert int(got.status) == int(ref.status)
        assert int(got.iters) <= int(tsel.order_statistic(
            xb, k, method="binned").iters)


class _LargestOutput(TorchDispatchMode):
    """Records the largest ``numel`` of any tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
        return out


@pytest.mark.parametrize("weighted", [False, True])
def test_polished_quantiles_never_materialize_k_by_n(weighted):
    n, k = 1 << 17, 8
    rng = np.random.default_rng(6)
    x = _t(rng.standard_normal(n).astype(np.float32))
    w = _t(rng.integers(0, 3, n).astype(np.float32))
    qs = np.linspace(0.05, 0.95, k)
    with _LargestOutput() as mode:
        if weighted:
            res = tsel.weighted_quantiles(x, w, qs, method="binned_polish")
        else:
            res = tsel.quantiles(x, qs, method="binned_polish")
    assert n <= mode.largest < k * n, mode.largest
    if not weighted:
        ks = tsel.ranks_from_quantiles(qs, n).numpy()
        np.testing.assert_array_equal(res.value.numpy(),
                                      [kth(x.numpy(), int(j)) for j in ks])


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------


def _drift(x, seed, frac=0.01):
    rng = np.random.default_rng(seed)
    return x + (rng.integers(-2, 3, x.shape) * (rng.random(x.shape) < frac)
                ).astype(np.float32)


def test_warm_binned_state_matches_reference():
    """A reference-made prior through ``prior_from_numpy``: the port's warm
    result equals the reference's warm result field for field, and its
    own cold result in value (binned family with the polish: the prior's
    edges and its cut seed both act)."""
    method = "binned_polish"
    x = _ints(30, N)
    x2 = _drift(x, 31)
    k = N // 3
    pr = jsel.as_prior(jsel.order_statistic(jnp.asarray(x), k, method=method,
                                            backend="jnp"))
    ref = jsel.order_statistic(jnp.asarray(x2), k, method=method,
                               backend="jnp", prior=pr)
    got = tsel.order_statistic(_t(x2), k, method=method,
                               prior=_port_prior(pr))
    assert_same_result(got, ref)
    cold = tsel.order_statistic(_t(x2), k, method=method)
    assert _bits(got.value.numpy()) == _bits(cold.value.numpy())


@pytest.mark.parametrize("method", ["binned", "binned_polish", "cp",
                                    "bisection"])
def test_warm_equals_cold(method):
    """Warm == cold bit for bit on scalar, rows, multi-k, weighted and
    log1p calls; an unchanged prior re-certifies in one sweep or pass."""
    x = _regime("randn") + np.float32(0.5)
    xt = _t(x)
    k = N // 3
    cold = tsel.order_statistic(xt, k, method=method)
    warm = tsel.order_statistic(xt, k, method=method, prior=cold)
    assert _bits(warm.value.numpy()) == _bits(cold.value.numpy())
    assert int(warm.iters) == 1 and int(warm.status) == tsel.EXACT_HIT
    ks = _t(np.array([5, N // 2, N - 5], np.int32))
    for call in (
            lambda **kw: tsel.select_rows(xt.reshape(2, -1), ks[:2],
                                          method=method, **kw),
            lambda **kw: tsel.multi_order_statistic(xt, ks, method=method,
                                                    **kw),
            lambda **kw: tsel.weighted_quantiles(xt, xt.abs(), [0.2, 0.7],
                                                 method=method, **kw),
            lambda **kw: tsel.quantiles(xt.abs() * 1e30, [0.1, 0.5],
                                        method=method, transform="log1p",
                                        **kw)):
        c = call()
        w = call(prior=c)
        np.testing.assert_array_equal(_bits(w.value.numpy()),
                                      _bits(c.value.numpy()))
        assert int(w.iters.max()) <= int(c.iters.max())


def _adversarial_priors(x, k):
    """The adversarial priors of ``tests/test_warm_start.py``."""
    ans = float(kth(x, k))
    far = float(np.max(x)) + 1e6
    mk = lambda v, lo, hi, c: tsel.Prior(  # noqa: E731
        *(torch.tensor(f, dtype=torch.float32) for f in (v, lo, hi, c)))
    return {
        "nan_value": mk(np.nan, ans - 1, ans + 1, ans),
        "nan_all": mk(np.nan, np.nan, np.nan, np.nan),
        "inf_cut": mk(ans, ans - 1, ans + 1, np.inf),
        "neg_inf_cut": mk(ans, ans - 1, ans + 1, -np.inf),
        "inf_bracket": mk(0.0, -np.inf, np.inf, 0.0),
        "bracket_excludes_answer": mk(far, far - 1, far + 1, far),
        "inverted_bracket": mk(ans, ans + 5, ans - 5, ans),
        "zero_width": mk(far, far, far, far),
    }


@pytest.mark.parametrize("method", ["binned", "binned_polish", "cp"])
def test_adversarial_priors_change_no_value(method):
    x = _regime("tie_storm") + _regime("randn")
    k = N // 2
    cold = tsel.order_statistic(_t(x), k, method=method)
    priors = _adversarial_priors(x, k)
    # a prior realized on another array, and one stale after the data was
    # replaced whole
    other = _regime("lognormal")
    priors["wrong_array"] = tsel.order_statistic(_t(other), N // 4)
    for name, pr in priors.items():
        warm = tsel.order_statistic(_t(x), k, method=method, prior=pr)
        assert warm.value.item() == cold.value.item() == kth(x, k), name
        assert int(warm.status) != tsel.NOT_CONVERGED, name
    stale = -3.0 * x + 100.0
    warm = tsel.order_statistic(_t(stale), k, method=method, prior=cold)
    assert warm.value.item() == kth(stale, k)


# ---------------------------------------------------------------------------
# the stream helpers
# ---------------------------------------------------------------------------


def test_tracker_steady_state_and_reset():
    rng = np.random.default_rng(23)
    base = rng.standard_normal(N).astype(np.float32)
    t = tstream.QuantileTracker(0.5, method="binned")
    for tick in range(5):
        x = base + np.float32(0.001 * tick) * rng.standard_normal(
            N).astype(np.float32)
        res = t.update(_t(x))
        cold = tsel.quantile(_t(x), 0.5, method="binned")
        assert _bits(res.value.numpy()) == _bits(cold.value.numpy())
        assert res.value.item() == kth(x, (N + 1) // 2)
    assert t.sweeps[-1] == 1 and all(isinstance(s, int) for s in t.sweeps)
    assert all(s <= t.sweeps[0] for s in t.sweeps)
    t.reset()
    assert t.prior is None and t.sweeps == []
    t.update(_t(base))
    assert t.sweeps == [int(tsel.quantile(_t(base), 0.5,
                                          method="binned").iters)]


def test_reselect_survives_regime_change():
    rng = np.random.default_rng(24)
    a = rng.standard_normal(N).astype(np.float32)
    b = (100.0 + 50.0 * rng.standard_normal(N)).astype(np.float32)
    w = rng.integers(1, 4, N).astype(np.float32)
    k = N // 2
    _, pr = tstream.reselect(_t(a), k, method="binned")
    res, pr = tstream.reselect(_t(b), k, prior=pr, method="binned")
    assert res.value.item() == kth(b, k)
    res2, _ = tstream.reselect(_t(b), k, prior=pr, method="binned")
    assert res2.value.item() == kth(b, k) and int(res2.iters) <= 1
    wk = float(w.sum()) / 2
    wres, wpr = tstream.reselect(_t(b), k=wk, weights=_t(w),
                                 method="binned_polish")
    again, _ = tstream.reselect(_t(b), k=wk, weights=_t(w), prior=wpr,
                                method="binned_polish")
    assert again.value.item() == wres.value.item()
    assert int(again.iters) == 1
