"""The port's selection engine held against the JAX reference and numpy.

Same numpy inputs through ``repro.core.selection`` (the reference, jnp
backend, as its own tests run it on the CPU) and ``repro_torch`` on the
CPU (``device="cpu"``), over the regimes of ``test_binned_selection.py``
and ``test_unified_parity.py``.  Values must equal ``np.partition`` bit
for bit.  On the binned leg both engines make the same decisions from
exact counts against the same realized edges, so every ``SelectResult``
field must be equal; on the cp leg the pivots come from f32 sums taken in
another order, so only the value is compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro_torch.convert import from_numpy, select_result_from_numpy  # noqa: E402,E501
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.kernels import cp_objective  # noqa: E402


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


def kth_rows(x, ks):
    x = np.asarray(x)
    ks = np.broadcast_to(np.asarray(ks), (x.shape[0],))
    return np.array([np.partition(row, k - 1)[k - 1]
                     for row, k in zip(x, ks)], x.dtype)


def _port(x, dtype=None):
    t = from_numpy(x, device="cpu")
    return t if dtype is None else t.to(dtype)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def assert_same_result(got, ref, fields=FIELDS):
    """Every named field equal, bit for bit, dtype included."""
    want = select_result_from_numpy(
        type(ref)(*(np.asarray(f) for f in ref)), device="cpu")
    for name in fields:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        np.testing.assert_array_equal(_bits(g.float().numpy()
                                            if g.dtype == torch.bfloat16
                                            else g.numpy()),
                                      _bits(w.float().numpy()
                                            if w.dtype == torch.bfloat16
                                            else w.numpy()), err_msg=name)


def _rows_both(x, ks, **kw):
    ref = jsel.select_rows(jnp.asarray(x), jnp.asarray(ks, jnp.int32), **kw)
    got = tsel.select_rows(_port(x), torch.as_tensor(ks), **kw)
    return got, ref


# ---------------------------------------------------------------------------
# binned leg: every field equal.  Regimes share two shapes so that the
# reference compiles each configuration once.
# ---------------------------------------------------------------------------

SMALL_B, SMALL_N, SMALL_CAP = 4, 4096, 8
LARGE_B, LARGE_N = 4, 100_000


def _small_regime(kind, rng):
    b, n = SMALL_B, SMALL_N
    ks = rng.integers(1, n + 1, size=b).astype(np.int32)
    if kind == "normal":
        x = rng.standard_normal((b, n))
    elif kind == "dup_heavy":
        x = rng.integers(0, 4, size=(b, n))
    elif kind.startswith("constant"):
        x = np.stack([np.full(n, 3.25), rng.standard_normal(n),
                      np.full(n, -7.0), rng.standard_normal(n)])
        ks = {"constant_first": [1] * 4, "constant_last": [n] * 4,
              "constant_ends": [1, 2, n - 1, n],
              "constant_middle": [n // 2] * 4}[kind]
    elif kind == "tie_storm":
        # half of each row is one value, the cap far below the tie count
        x = rng.standard_normal((b, n))
        x[rng.random((b, n)) < 0.5] = 0.125
        ks = np.array([n // 2, n // 3, 2 * n // 3, n // 2 + 7])
    return np.asarray(x, np.float32), np.asarray(ks, np.int32)


@pytest.mark.parametrize("kind", ["normal", "dup_heavy", "constant_first",
                                  "constant_last", "constant_ends",
                                  "constant_middle", "tie_storm"])
def test_binned_small_rows_tiny_cap(kind):
    x, ks = _small_regime(kind, np.random.default_rng(len(kind)))
    got, ref = _rows_both(x, ks, method="binned", cap=SMALL_CAP)
    assert_same_result(got, ref)
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(x, ks))
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)


def test_binned_tiny_normal_magnitudes():
    """Smallest-normal-scale data: the bin width is denormal.  The port
    keeps it and narrows sweep by sweep; the jitted reference flushes it to
    zero and stalls after one sweep into its finalize fallback.  The
    answers agree; the sweep counts and brackets cannot."""
    rng = np.random.default_rng(5)
    x = (rng.integers(0, 3, (SMALL_B, SMALL_N)).astype(np.float32)
         * np.float32(1.2e-38))
    ks = np.array([1, SMALL_N // 2, SMALL_N // 3, SMALL_N], np.int32)
    got, ref = _rows_both(x, ks, method="binned", cap=SMALL_CAP)
    assert_same_result(got, ref, fields=("value",))
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(x, ks))
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)


def test_binned_nbins_not_power_of_two():
    """100 bins: ``/ nbins`` is a reciprocal multiply in the compiled
    reference, which the port's edges reproduce."""
    x, ks = _small_regime("normal", np.random.default_rng(9))
    got, ref = _rows_both(x, ks, method="binned", cap=SMALL_CAP, nbins=100)
    assert_same_result(got, ref)


def _large_regime(kind, rng):
    b, n = LARGE_B, LARGE_N
    x = rng.standard_normal((b, n)).astype(np.float32)
    ks = rng.integers(1, n + 1, size=b).astype(np.int32)
    if kind in ("full_range", "plus_inf"):
        # data spanning ±3e38: the edge width overflows f32 unless divided
        # first; +inf makes the first sweep's top edges clip to inf
        x[:, 0], x[:, 1] = 3e38, -3e38
        if kind == "plus_inf":
            x[:, 2] = np.inf
        ks = np.array([2, n // 2, n - 1, n], np.int32)
    elif kind == "both_inf":
        # -inf as a bracket end makes every edge but the last -inf: only
        # k = 1, 2, n resolve (through the extreme and tie-fallback
        # certificates), on both engines — see ROADMAP Queue 3
        x[:, 5], x[:, 9] = np.inf, -np.inf
        ks = np.array([1, 2, n, 1], np.int32)
    return x, ks


@pytest.mark.parametrize("kind", ["normal", "full_range", "plus_inf",
                                  "both_inf"])
def test_binned_large_rows_128_bins(kind):
    """n >= BINNED_MIN_N at the kernel path's 128 bins."""
    x, ks = _large_regime(kind, np.random.default_rng(40 + len(kind)))
    got, ref = _rows_both(x, ks, nbins=tsel.DEF_NBINS)
    assert_same_result(got, ref)
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(x, ks))
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)


def test_binned_bf16_matches_reference():
    """bf16 data, f32 brackets: the comparisons against the (B, 1) f32
    brackets run in f32 on both sides."""
    rng = np.random.default_rng(6)
    x32 = rng.standard_normal((LARGE_B, LARGE_N)).astype(np.float32)
    ks = np.array([1, LARGE_N // 2, LARGE_N // 3, LARGE_N], np.int32)
    ref = jsel.select_rows(jnp.asarray(x32, jnp.bfloat16), jnp.asarray(ks))
    got = tsel.select_rows(_port(x32, torch.bfloat16), torch.as_tensor(ks))
    assert_same_result(got, ref)
    xb = np.asarray(jnp.asarray(x32, jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(xb, ks))


def test_binned_log1p_extreme_magnitudes():
    """1e20-scale components: sweeps on the log1p image, bracket mapped
    back count-preservingly, answers exact."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((SMALL_B, SMALL_N)).astype(np.float32)
    x[:, :16] = 1e20
    x[2] *= 1e10
    ks = np.array([SMALL_N // 2, 1, SMALL_N // 3, SMALL_N], np.int32)
    got, ref = _rows_both(x, ks, method="binned", cap=SMALL_CAP,
                          transform="log1p")
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(x, ks))
    assert_same_result(got, ref)


def test_median_2_20_matches_reference():
    """The one large parity check: the 1M median takes the reference's
    sweeps and brackets."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal(1 << 20).astype(np.float32)
    ref = jsel.median(jnp.asarray(x))
    got = tsel.median(_port(x))
    assert_same_result(got, ref)
    assert float(got.value) == np.partition(x, (x.size + 1) // 2 - 1)[
        (x.size + 1) // 2 - 1]
    assert int(got.iters) <= 4


# ---------------------------------------------------------------------------
# cp leg and the other methods: value equal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["cp", "cp_hybrid", "bisection", "golden",
                                    "brent", None])
def test_cp_family_values_match(method):
    """Every cp-family proposal on the small regime: value equal to
    np.partition; the reference's value too for ``cp`` (its pivots differ
    in the last bits, its answer may not)."""
    x, ks = _small_regime("normal", np.random.default_rng(11))
    x[1] = np.round(x[1] * 3)  # duplicate-heavy row
    x[2, :500] = 0.0  # tie block
    got = tsel.select_rows(_port(x), torch.as_tensor(ks), method=method,
                           cap=SMALL_CAP)
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(x, ks))
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)
    if method == "cp":
        ref = jsel.select_rows(jnp.asarray(x), jnp.asarray(ks),
                               method="cp", cap=SMALL_CAP)
        np.testing.assert_array_equal(got.value.numpy(),
                                      np.asarray(ref.value))


def test_cp_bf16_values_exact():
    """The reference cannot run the cp family on bf16 (its while_loop carry
    changes dtype); the port's answers equal np.partition's."""
    rng = np.random.default_rng(12)
    b, n = 3, 5000
    x32 = rng.standard_normal((b, n)).astype(np.float32)
    xb = _port(x32, torch.bfloat16)
    ks = np.array([1, n // 2, n], np.int32)
    got = tsel.select_rows(xb, torch.as_tensor(ks), method="cp")
    np.testing.assert_array_equal(got.value.float().numpy(),
                                  kth_rows(xb.float().numpy(), ks))


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_denormal_data_exact(method):
    """True denormals: the port (like the GPU kernels) compares them
    exactly and returns np.partition's answer; the jitted reference flushes
    them to zero, so it is not the oracle here."""
    rng = np.random.default_rng(13)
    x = (rng.integers(-2, 3, 2048).astype(np.float32)) * np.float32(1e-44)
    for k in [1, 700, 1024, 1500, 2048]:
        got = tsel.order_statistic(_port(x), k, method=method, cap=8)
        # == rather than bits: an EXACT_HIT returns the certified pivot,
        # which may be -0.0 where the data holds 0.0
        assert float(got.value) == np.partition(x, k - 1)[k - 1], k
        assert int(got.status) != tsel.NOT_CONVERGED


def test_cp_log1p_values_match():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((3, 8192)).astype(np.float32)
    x[:, :8] = 1e20
    ks = np.array([1, 4096, 8192], np.int32)
    got = tsel.select_rows(_port(x), torch.as_tensor(ks), method="cp",
                           transform="log1p")
    np.testing.assert_array_equal(got.value.numpy(), kth_rows(x, ks))


def test_sort_method_matches_reference():
    rng = np.random.default_rng(15)
    x = rng.standard_normal((3, 1000)).astype(np.float32)
    ks = np.array([1, 500, 1000], np.int32)
    got, ref = _rows_both(x, ks, method="sort")
    assert_same_result(got, ref)


# ---------------------------------------------------------------------------
# scalar views: order_statistic, median, quantile, topk_threshold
# ---------------------------------------------------------------------------


def test_scalar_views_match_reference():
    rng = np.random.default_rng(16)
    n = 80_000
    x = rng.standard_normal(n).astype(np.float32)
    xs = np.sort(x)
    xt = _port(x)
    for q in [0.0, 0.01, 0.5, 0.999999, 1.0]:
        got = tsel.quantile(xt, q)
        assert_same_result(got, jsel.quantile(jnp.asarray(x), q))
        assert float(got.value) == xs[int(np.clip(np.ceil(q * n), 1, n)) - 1]
    for m in [1, 10, n]:
        got = tsel.topk_threshold(xt, m)
        assert_same_result(got, jsel.topk_threshold(jnp.asarray(x), m))
        assert float(got.value) == xs[n - m]
    got = tsel.median(xt[:1001], method="cp")
    assert float(got.value) == np.sort(x[:1001])[500]


def test_ranks_from_quantiles_host_f64():
    """q -> k in f64 on the host: f32 would land one rank low at n = 2^25."""
    n = 1 << 25
    got = tsel.ranks_from_quantiles([0.999999, 0.5, 0.0, 1.0], n)
    want = np.asarray(jsel.ranks_from_quantiles([0.999999, 0.5, 0.0, 1.0], n))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got[0]) == 33554399


def test_cpu_path_runs_no_kernel():
    cp_objective.reset_launches()
    x = _port(np.arange(70_000, dtype=np.float32)[::-1].copy())
    assert float(tsel.median(x).value) == 34_999.0
    assert float(tsel.median(x, method="cp").value) == 34_999.0
    assert cp_objective.LAUNCHES["cp_histogram_batched"] == 0
    assert cp_objective.LAUNCHES["cp_partials_batched"] == 0
    assert not any(cp_objective.LAUNCHES.values())


def test_kernel_wrappers_raise_off_the_card():
    x = torch.zeros((1, 8))
    with pytest.raises(ValueError):
        cp_objective.cp_partials_batched(x, torch.zeros(1))
    with pytest.raises(ValueError):
        cp_objective.cp_histogram_batched(x, torch.zeros((1, 3)))


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_strided_views(method):
    """Views that are not contiguous answer like their copies."""
    rng = np.random.default_rng(21)
    x = rng.standard_normal((3, 2 * SMALL_N)).astype(np.float32)
    xt = _port(x)
    got = tsel.median(xt[0, ::2], method=method)
    assert float(got.value) == kth_rows(x[:1, ::2], SMALL_N // 2)[0]
    ks = np.array([1, 77, SMALL_N], np.int32)
    got = tsel.select_rows(xt[:, :SMALL_N], torch.as_tensor(ks),
                           method=method)
    np.testing.assert_array_equal(got.value.numpy(),
                                  kth_rows(x[:, :SMALL_N], ks))


def test_unported_options_raise():
    x = _port(np.ones(10, np.float32))
    with pytest.raises(ValueError):
        tsel.median(x, method="nope")
    with pytest.raises(ValueError):
        tsel.select_rows(x, 1)
