"""The port's weighted order statistics held against the JAX reference.

Same numpy inputs through ``repro.core.selection``'s weighted entry points
(jnp backend, as ``tests/test_weighted_selection.py`` runs them) and the
port on the CPU (``device="cpu"``), over the regimes of that file.  The
weights are exactly summable (small integers, totals far below 2^24), so
every mass comparison is exact in both engines: values must equal the
reference's sorted-cumsum oracle bit for bit on every method, and on the
binned leg every ``SelectResult`` field must equal the reference's (at
three shapes — scalar, rows and shared — since each shape costs the
reference a jit compile of seconds; the other regimes hold the port's
values to the oracle).  The
cp family steers its pivots by f32 objective sums taken in another order
than the reference's, so there only the value is held (the reference's own
tests hold its values to the same oracle).  The jitted reference flushes
denormals to zero (ROADMAP Queue 3), so in the denormal regime only the
port's values are held.

Also here: the plain K1w-K4w versions against ``repro.kernels.ref``'s
oracles and the TPU bodies in interpret mode, the either-f64 dispatch
rule, and the no-``(K, n)`` guarantee of the weighted multi path.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro.kernels import cp_objective as jcp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import from_numpy, select_result_from_numpy  # noqa: E402,E501
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.kernels import cp_objective, ops  # noqa: E402
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


FIELDS = ("value", "iters", "status", "y_lo", "y_hi", "n_in")
CP_FAMILY = ("cp", "bisection", "golden", "brent")
# f32 objective sums (sum w*|x - y|) of a few thousand terms taken in
# another order: within n * 2^-24 ~ 5e-4 relative at worst (n = 8192)
SUM_RTOL = 1e-3


def _port(x, dtype=None):
    """``x`` on the CPU, cast to ``dtype`` (a name, as ``"bfloat16"``)."""
    t = from_numpy(x, device="cpu")
    return t if dtype is None else t.to(getattr(torch, dtype))


def _ref(x, dtype=None):
    return jnp.asarray(x, None if dtype is None else getattr(jnp, dtype))


def _bits(t):
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_result(got, ref):
    """Every field equal, bit for bit, dtype included."""
    want = select_result_from_numpy(
        type(ref)(*(np.asarray(f) for f in ref)), device="cpu")
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=name)


def weighted_oracle(x, w, wk):
    """Smallest element v with sum(w[x <= v]) >= wk, by sorted cumsum in
    f64 (the oracle of ``tests/test_weighted_selection.py``)."""
    o = np.argsort(x, kind="stable")
    xs, ws = np.asarray(x)[o], np.asarray(w)[o]
    c = np.cumsum(ws.astype(np.float64))
    i = np.searchsorted(c, wk, side="left")
    return xs[min(i, len(xs) - 1)]


def _check_scalar(x, w, wks, method, cap=None, xdt=None, wdt=None,
                  reference=False):
    """The port's ``weighted_order_statistic`` at each target mass: value
    equal to the oracle and never NOT_CONVERGED; with ``reference``, on the
    binned leg every field equal to the reference's (one jit per shape,
    shared by the targets)."""
    xv = _port(x, xdt).float().numpy()
    kw = {} if cap is None else {"cap": cap}
    for wk in map(np.float32, wks):  # one jit signature for the reference
        got = tsel.weighted_order_statistic(_port(x, xdt), _port(w, wdt), wk,
                                            method=method, **kw)
        assert got.value.float().item() == weighted_oracle(xv, w, wk), \
            (method, wk)
        assert int(got.status) != tsel.NOT_CONVERGED
        if reference and method == "binned":
            ref = jsel.weighted_order_statistic(_ref(x, xdt), _ref(w, wdt),
                                                wk, method=method,
                                                backend="jnp", **kw)
            assert_same_result(got, ref)


# ---------------------------------------------------------------------------
# scalar (B = 1): the regimes of test_weighted_selection.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["binned", *CP_FAMILY, "sort"])
def test_uniform_weights_reproduce_unweighted(method):
    """w == 1 and wk == k give the counting leg's answer bit for bit (on
    the binned leg every field: the decisions are the same exact
    comparisons)."""
    rng = np.random.default_rng(0)
    n = 4097
    x = rng.standard_normal(n).astype(np.float32)
    w = np.ones(n, np.float32)
    ks = [1, 2, n // 3, (n + 1) // 2, n - 1, n]
    for k in ks:
        got = tsel.weighted_order_statistic(_port(x), _port(w), float(k),
                                            method=method)
        unw = tsel.order_statistic(_port(x), k, method=method)
        assert got.value.item() == np.partition(x, k - 1)[k - 1], (method, k)
        assert got.value.item() == unw.value.item(), (method, k)
        if method == "binned":
            for name in ("iters", "status", "y_lo", "y_hi", "n_in"):
                np.testing.assert_array_equal(
                    _bits(getattr(got, name)), _bits(getattr(unw, name)),
                    err_msg=name)


@pytest.mark.parametrize("method", ["binned", "cp", "bisection", "sort"])
@pytest.mark.parametrize("n", [1, 2, 50, 1000, 20_000])
def test_integer_weights_match_reference(method, n):
    rng = np.random.default_rng(n)
    x = rng.integers(-(2 ** 20), 2 ** 20, n).astype(np.float32) * 2.0 ** -10
    w = rng.integers(0, 8, n).astype(np.float32)
    w[0] = 1.0  # at least some mass
    W = w.sum()
    wks = [max(frac * W, 0.5) for frac in (0.0005, 0.25, 0.5, 0.9, 1.0)]
    _check_scalar(x, w, wks, method, cap=16, reference=n == 1000)


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_duplicate_storm_and_zero_weights(method):
    """Tie blocks with zero-weight members: the answer skips massless
    elements exactly as the cumsum oracle does."""
    rng = np.random.default_rng(1)
    x = np.repeat(np.array([1.0, 2.0, 3.0, 4.0], np.float32), 1000)
    w = np.tile(np.array([0.0, 1.0, 2.0, 1.0], np.float32), 1000)
    p = rng.permutation(4000)
    x, w = x[p], w[p]
    wks = [frac * w.sum() for frac in (0.01, 0.3, 0.5, 0.75, 0.99)]
    _check_scalar(x, w, wks, method, cap=4)


@pytest.mark.parametrize("method", [None, "binned", "sort"])
def test_wk_edges_and_clipping(method):
    """wk <= 0 pins the minimum; wk past the total mass clips to the
    maximum (on the binned leg at the shape of the integer regime's
    reference check, so the reference's compile is shared)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal(1000).astype(np.float32)
    w = rng.integers(1, 4, 1000).astype(np.float32)
    lo = tsel.weighted_order_statistic(_port(x), _port(w), 0.0, method=method)
    assert lo.value.item() == x.min()
    hi = tsel.weighted_order_statistic(_port(x), _port(w), 10.0 * w.sum(),
                                       method=method)
    assert hi.value.item() == x.max()
    _check_scalar(x, w, [0.0, -3.0, 10.0 * w.sum()], method, cap=16,
                  reference=True)


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_extreme_magnitudes(method):
    """1e9-scale outliers: the binned sweeps localize mass without a
    transform, bit-exact against the oracle and the reference."""
    rng = np.random.default_rng(3)
    n = 100_000
    x = rng.standard_normal(n).astype(np.float32)
    x[:4] = [1e9, -1e9, 3e8, -7e8]
    w = rng.integers(1, 3, n).astype(np.float32)
    _check_scalar(x, w, [0.5 * w.sum()], method)


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_bf16_data_and_weights(method):
    """bf16 x with bf16 weights (small integers, exact in bf16): f32 masses
    and brackets; the reference raises on bf16 in the cp family (ROADMAP
    Queue 3), so there the port is held to the oracle."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(3000).astype(np.float32)
    w = rng.integers(0, 5, 3000).astype(np.float32)
    w[0] = 1.0
    wks = [frac * w.sum() for frac in (0.1, 0.5, 0.95)]
    _check_scalar(x, w, wks, method, xdt="bfloat16", wdt="bfloat16")


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_denormal_data_values_exact(method):
    """Subnormal data: the reference flushes it, the port compares it
    exactly, so only the port's values are held (against the oracle)."""
    rng = np.random.default_rng(5)
    x = (rng.integers(-3, 4, 4096) * 1e-44).astype(np.float32)
    w = rng.integers(0, 4, 4096).astype(np.float32)
    w[0] = 1.0
    for frac in (0.01, 0.5, 0.99):
        wk = frac * w.sum()
        got = tsel.weighted_order_statistic(_port(x), _port(w), wk,
                                            method=method, cap=8)
        assert got.value.item() == weighted_oracle(x, w, wk), (method, frac)
        assert int(got.status) != tsel.NOT_CONVERGED


# ---------------------------------------------------------------------------
# rows mode, shared-x mode, wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["binned", "cp", "sort"])
@pytest.mark.parametrize("b,n", [(1, 1000), (8, 4096), (33, 257)])
def test_weighted_rows_match_reference(method, b, n):
    rng = np.random.default_rng(b * n)
    x = rng.integers(-1000, 1000, (b, n)).astype(np.float32)
    w = rng.integers(0, 5, (b, n)).astype(np.float32)
    w[:, 0] = 1.0
    wks = (rng.uniform(0.05, 1.0, b) * w.sum(axis=1)).astype(np.float32)
    got = tsel.weighted_select_rows(_port(x), _port(w), _port(wks),
                                    method=method, cap=8)
    want = np.array([weighted_oracle(x[i], w[i], wks[i]) for i in range(b)],
                    np.float32)
    np.testing.assert_array_equal(got.value.numpy(), want)
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)
    if method == "binned" and b == 33:
        assert_same_result(got, jsel.weighted_select_rows(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(wks), method=method,
            cap=8, backend="jnp"))


WKS_FRACS = np.array([1e-3, 0.1, 0.25, 0.5, 0.75, 0.999, 1.0], np.float32)


@pytest.mark.parametrize("method", ["binned", "cp", "sort"])
def test_weighted_shared_matches_reference(method):
    rng = np.random.default_rng(10)
    n = 30_000
    x = rng.integers(-500, 500, n).astype(np.float32)
    w = rng.integers(0, 4, n).astype(np.float32)
    w[0] = 1.0
    wks = WKS_FRACS * w.sum()
    got = tsel.weighted_multi_order_statistic(_port(x), _port(w), _port(wks),
                                              method=method, cap=8)
    want = np.array([weighted_oracle(x, w, t) for t in wks], np.float32)
    np.testing.assert_array_equal(got.value.numpy(), want)
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)
    if method in ("binned", "sort"):
        assert_same_result(got, jsel.weighted_multi_order_statistic(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(wks), method=method,
            cap=8, backend="jnp"))


def test_shared_k1_equals_scalar():
    """K = 1 on the weighted shared evaluator is the B = 1 rows problem:
    every field equal at the same cap."""
    rng = np.random.default_rng(12)
    x = rng.integers(-50, 50, 6000).astype(np.float32)
    w = rng.integers(0, 3, 6000).astype(np.float32)
    for method in ("binned", "cp"):
        for wk in (1.0, 0.37 * w.sum(), w.sum()):
            got = tsel.weighted_multi_order_statistic(
                _port(x), _port(w), [wk], method=method, cap=64)
            want = tsel.weighted_order_statistic(_port(x), _port(w), wk,
                                                 method=method, cap=64)
            for name in FIELDS:
                np.testing.assert_array_equal(
                    _bits(getattr(got, name)),
                    _bits(getattr(want, name)[None]), err_msg=name)


@pytest.mark.parametrize("method", [None, "binned"])
def test_weighted_median_and_quantiles_wrappers(method):
    rng = np.random.default_rng(11)
    n = 5000
    x = rng.standard_normal(n).astype(np.float32)
    w = rng.integers(1, 6, n).astype(np.float32)
    med = tsel.weighted_median(_port(x), _port(w), method=method)
    assert med.value.item() == weighted_oracle(x, w, 0.5 * w.sum())
    q = tsel.weighted_quantile(_port(x), _port(w), 0.3, method=method)
    assert q.value.item() == weighted_oracle(x, w, np.float32(0.3)
                                             * w.sum())
    qs = [0.1, 0.5, 0.9]
    res = tsel.weighted_quantiles(_port(x), _port(w), qs, method=method)
    want = np.array([weighted_oracle(x, w, qq * w.sum()) for qq in qs],
                    np.float32)
    np.testing.assert_array_equal(res.value.numpy(), want)
    # uniform weights: the weighted median is the median
    ones = _port(np.ones(n, np.float32))
    assert tsel.weighted_median(_port(x), ones, method=method).value.item() \
        == tsel.median(_port(x), method=method).value.item()


def test_weighted_binned_sweep_count():
    """The weighted binned descent keeps the counting leg's few-sweep
    schedule (``test_weighted_binned_sweep_count`` runs 1M; 2^17 here):
    as many sweeps as the unweighted median of the same data."""
    rng = np.random.default_rng(14)
    n = 1 << 17
    x = rng.standard_normal(n).astype(np.float32)
    w = rng.integers(1, 3, n).astype(np.float32)
    got = tsel.weighted_median(_port(x), _port(w), method="binned")
    assert got.value.item() == weighted_oracle(x, w, 0.5 * w.sum())
    assert int(got.iters) <= 3, int(got.iters)
    assert int(got.iters) == int(tsel.median(_port(x), method="binned").iters)


# ---------------------------------------------------------------------------
# the plain K1w-K4w versions and the dispatch rule
# ---------------------------------------------------------------------------


def _special_data(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    idx = rng.choice(n, size=44, replace=False)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 3e38, -3e38,
                        1e-3, -1e-3, 2.0, -2.0], np.float32)
    x[idx] = special[np.arange(idx.size) % special.size]
    return x


def _ladders(nbins):
    """Data-scale, full-range, one-ulp (duplicated edges), a repeat of the
    first (identical ladders, as in a first sweep) and a narrow ladder."""
    kinds = [(-2.0, 2.0), (-3e38, 3e38),
             (0.25, float(np.nextafter(np.float32(0.25), np.float32(1)))),
             (-2.0, 2.0), (-1e-3, 2e-3)]
    lo = torch.tensor([k[0] for k in kinds])
    hi = torch.tensor([k[1] for k in kinds])
    return tref.bin_edges(lo, hi, nbins).numpy()


@pytest.mark.parametrize("xdt,wdt", [("float32", "float32"),
                                     ("bfloat16", "float32"),
                                     ("float32", "bfloat16"),
                                     ("bfloat16", "bfloat16")])
def test_plain_versions_match_reference(xdt, wdt):
    """The six plain weighted versions against ``repro.kernels.ref``'s
    ``wcp_*_ref`` on identical inputs with ±inf and NaN in the data and
    zero weights among integer ones: counts and masses bit for bit (every
    partial mass is an integer below 2^24), the per-slot sum(w*x) and the
    objective sums within SUM_RTOL (reduced in another order)."""
    rng = np.random.default_rng(7)
    n = 8192
    x = _special_data(rng, n)
    w = rng.integers(0, 4, n).astype(np.float32)
    xt, wt = _port(x, xdt), _port(w, wdt)
    xj, wj = _ref(x, xdt), _ref(w, wdt)
    edges = _ladders(16)

    def same(got, want, exact):
        for g, v in zip(got, want):
            v = np.asarray(v)
            if exact:
                np.testing.assert_array_equal(g.numpy(), v)
                assert g.dtype == (torch.int32 if v.dtype == np.int32
                                   else torch.float32)
            else:
                np.testing.assert_allclose(g.numpy(), v, rtol=SUM_RTOL)

    # histograms: one ladder, K ladders, and B rows of one ladder each
    got = tref.wcp_histogram_ref(xt, wt, _port(edges[0]))
    want = jref.wcp_histogram_ref(xj, wj, jnp.asarray(edges[0]),
                                  impl="searchsorted")
    same(got[:2], want[:2], True)
    got = tref.wcp_histogram_multi_ref(xt, wt, _port(edges))
    want = jref.wcp_histogram_multi_ref(xj, wj, jnp.asarray(edges),
                                        impl="searchsorted")
    same(got[:2], want[:2], True)
    assert tref.wcp_histogram_multi_ref(xt, wt, _port(edges),
                                        want_sums=False)[2] is None
    rows = 5
    xb, wb = xt[: rows * 1000].reshape(rows, 1000), \
        wt[: rows * 1000].reshape(rows, 1000)
    got = tref.wcp_histogram_batched_ref(xb, wb, _port(edges))
    want = jref.wcp_histogram_batched_ref(
        xj[: rows * 1000].reshape(rows, 1000),
        wj[: rows * 1000].reshape(rows, 1000), jnp.asarray(edges),
        impl="searchsorted")
    same(got[:2], want[:2], True)
    assert np.all(got[0].numpy().sum(axis=1) == 1000)

    # partials: scalar, K pivots, and B rows
    y = np.array([0.0, 1.0, -0.5, 3e38, float(x[100])], np.float32)
    got = tref.wcp_partials_ref(xt, wt, float(y[4]))
    want = jref.wcp_partials_ref(xj, wj, jnp.float32(y[4]))
    same(got[2:], want[2:], True)
    got = tref.wcp_partials_multi_ref(xt, wt, _port(y))
    want = jref.wcp_partials_multi_ref(xj, wj, jnp.asarray(y))
    same(got[2:], want[2:], True)
    got = tref.wcp_partials_batched_ref(xb, wb, _port(y))
    want = jref.wcp_partials_batched_ref(
        xj[: rows * 1000].reshape(rows, 1000),
        wj[: rows * 1000].reshape(rows, 1000), jnp.asarray(y))
    same(got[2:], want[2:], True)
    # the objective sums and the per-slot sum(w*x) on finite data (±inf
    # data makes them inf or NaN in both)
    fin = np.isfinite(x)
    xf, wf = x[fin], w[fin]
    got = tref.wcp_histogram_multi_ref(_port(xf, xdt), _port(wf, wdt),
                                       _port(edges))
    want = jref.wcp_histogram_multi_ref(_ref(xf, xdt), _ref(wf, wdt),
                                        jnp.asarray(edges),
                                        impl="searchsorted")
    same(got[:2], want[:2], True)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=SUM_RTOL, atol=1e-3)
    got = tref.wcp_partials_multi_ref(_port(xf, xdt), _port(wf, wdt),
                                      _port(y[:3]))
    want = jref.wcp_partials_multi_ref(_ref(xf, xdt), _ref(wf, wdt),
                                       jnp.asarray(y[:3]))
    same(got[:4], want[:4], False)


def test_plain_versions_nan_semantics():
    """A NaN difference adds nothing to any weighted sum (``where``, as the
    reference), and NaN data lands in the top slot with its weight."""
    x = _port(np.array([np.nan, 1.0, -1.0, np.inf], np.float32))
    w = _port(np.array([5.0, 1.0, 2.0, 3.0], np.float32))
    sp, sn, wlt, wle, nlt, nle = tref.wcp_partials_ref(x, w, 0.0)
    assert sp.item() == np.inf and sn.item() == 2.0
    assert (wlt.item(), wle.item(), nlt.item(), nle.item()) == (2, 2, 1, 1)
    edges = tref.bin_edges(torch.tensor(-2.0), torch.tensor(2.0), 4)
    cnt, wcnt, wsum = tref.wcp_histogram_ref(x, w, edges)
    assert cnt.tolist() == [0, 1, 0, 1, 0, 2]
    assert wcnt.tolist() == [0, 2, 0, 1, 0, 8]


def test_plain_versions_match_pallas_interpret():
    """The weighted TPU bodies that K1w-K4w replace, in interpret mode at
    one small NaN-free input (the Pallas histogram counts NaN in no slot):
    counts and masses bit for bit."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal(2000).astype(np.float32)
    x[:4] = [np.inf, -np.inf, 2.0, -2.0]
    w = rng.integers(0, 4, 2000).astype(np.float32)
    edges = _ladders(16)[1:3]  # full range, one ulp (duplicated edges)
    cnt_p, wcnt_p, _ = jcp.wcp_histogram_multi(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(edges), block_rows=8,
        interpret=True, want_sums=False)
    cnt_t, wcnt_t, _ = tref.wcp_histogram_multi_ref(_port(x), _port(w),
                                                    _port(edges),
                                                    want_sums=False)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_p))
    np.testing.assert_array_equal(wcnt_t.numpy(), np.asarray(wcnt_p))
    xf, wf = x[4:], w[4:]
    y = np.array([0.1, float(xf[7])], np.float32)
    want = jcp.wcp_partials_multi(jnp.asarray(xf), jnp.asarray(wf),
                                  jnp.asarray(y), block_rows=8,
                                  interpret=True)
    got = tref.wcp_partials_multi_ref(_port(xf), _port(wf), _port(y))
    for g, v in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(v))
    for g, v in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(v), rtol=SUM_RTOL)


def test_either_f64_routes_to_the_plain_version():
    """The kernel rule widens to both operands: a CUDA tensor takes a
    weighted kernel only when neither x nor w is f64, so an f64 w on f32 x
    resolves to the plain version's 16 bins, not the kernel's 128.  (The
    rule reads only device and dtype, so stand-ins for CUDA tensors show
    it here; ``tests/test_torch_cuda.py`` runs it on the card.)"""
    cuda = torch.device("cuda")
    x32 = SimpleNamespace(device=cuda, dtype=torch.float32)
    for wdt, kernel in ((torch.float32, True), (torch.bfloat16, True),
                        (torch.float64, False)):
        w = SimpleNamespace(device=cuda, dtype=wdt)
        assert ops.uses_kernel_weighted(x32, w) is kernel
        assert tsel._resolve_nbins(None, x32, w) == (128 if kernel else 16)
    x64 = SimpleNamespace(device=cuda, dtype=torch.float64)
    w32 = SimpleNamespace(device=cuda, dtype=torch.float32)
    assert not ops.uses_kernel_weighted(x64, w32)
    assert tsel._resolve_nbins(7, x64, w32) == 7
    # on the CPU: an f64 w accumulates mass in f64, as the reference does
    rng = np.random.default_rng(9)
    x = rng.standard_normal(3000).astype(np.float32)
    w = rng.integers(1, 4, 3000).astype(np.float64)
    got = tsel.weighted_median(_port(x), _port(w), method="binned")
    assert got.value.item() == weighted_oracle(x, w, 0.5 * w.sum())
    assert tref._waccum_dtype(_port(x), _port(w)) == torch.float64


def test_weighted_k1_views_on_the_cpu():
    """``fused_weighted_histogram`` / ``fused_weighted_partials`` are row 0
    of the multi passes."""
    rng = np.random.default_rng(10)
    x = _port(_special_data(rng, 5000))
    w = _port(rng.integers(0, 4, 5000).astype(np.float32))
    edges = _port(_ladders(16))
    multi = ops.fused_weighted_histogram_multi(x, w, edges)
    one = ops.fused_weighted_histogram(x, w, edges[2])
    assert multi[2] is None and one[2] is None
    for a, b in zip(one[:2], multi[:2]):
        assert torch.equal(a, b[2])
    y = torch.tensor([0.5, -1.0])
    multi = ops.fused_weighted_partials_multi(x, w, y)
    for a, b in zip(ops.fused_weighted_partials(x, w, -1.0), multi):
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())


def test_weighted_wrappers_raise_off_the_card():
    x = _port(np.zeros(64, np.float32))
    e = tref.bin_edges(torch.tensor(-1.0), torch.tensor(1.0), 4)
    cp_objective.reset_launches()
    for call in (lambda: cp_objective.wcp_histogram_batched(x[None], x[None],
                                                            e[None]),
                 lambda: cp_objective.wcp_partials_batched(
                     x[None], x[None], torch.zeros(1)),
                 lambda: cp_objective.wcp_histogram_multi(x, x, e[None]),
                 lambda: cp_objective.wcp_histogram(x, x, e),
                 lambda: cp_objective.wcp_partials_multi(x, x,
                                                         torch.zeros(2)),
                 lambda: cp_objective.wcp_partials(x, x, 0.5)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    tsel.weighted_quantiles(x, x + 1, [0.1, 0.9])
    assert not any(cp_objective.LAUNCHES.values())


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


@pytest.mark.parametrize("method", ["binned", "cp", "sort"])
def test_weighted_quantiles_never_materialize_k_by_n(method):
    n, k = 1 << 17, 8
    rng = np.random.default_rng(6)
    x = rng.standard_normal(n).astype(np.float32)
    w = rng.integers(0, 3, n).astype(np.float32)
    qs = np.linspace(0.05, 0.95, k)
    with _LargestOutput() as mode:
        res = tsel.weighted_quantiles(_port(x), _port(w), qs, method=method)
    assert n <= mode.largest < k * n, mode.largest
    W = w.sum(dtype=np.float32)
    want = [weighted_oracle(x, w, np.float32(q * float(W))) for q in qs]
    np.testing.assert_array_equal(res.value.numpy(), np.asarray(want))


def test_unported_options_raise():
    x = _port(np.arange(100, dtype=np.float32))
    with pytest.raises(ValueError):
        tsel.weighted_select_rows(x, x, 3.0)
