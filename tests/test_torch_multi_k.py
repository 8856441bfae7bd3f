"""The port's shared-x multi-k selection held against the JAX reference.

Same numpy inputs through ``repro.core.selection.multi_order_statistic``
(jnp backend, as the reference's own tests run it on the CPU) and the port
on the CPU (``device="cpu"``), over the regimes of ``test_multi_k.py``.  On
the binned leg both engines decide from exact counts against the same
realized edges, so every ``SelectResult`` field must be equal; values must
equal ``np.partition`` everywhere.  The jitted reference flushes denormals
to zero (ROADMAP Queue 3), so in the denormal regime only the port's values
are held, against ``np.partition``.

Also here: the plain K3/K4 versions against the reference's and against
the Pallas bodies in interpret mode, the no-``(K, n)`` guarantee (every op
the port dispatches, recorded), and the sweep economy of shared sweeps.
"""
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
KS_FRACS = (0.001, 0.1, 0.25, 0.5, 0.5, 0.9, 0.999)  # dup k exercises ties
N = 6000
TINY = np.finfo(np.float32).tiny
# f32 sums of 3000 same-sign terms taken in another order: within
# n * 2^-24 ~ 2e-4 relative at worst, ~sqrt(n) * 2^-24 ~ 3e-6 here
SUM_RTOL = 1e-4


def _regime(kind):
    """The regimes of ``tests/test_multi_k.py``, one seed each."""
    rng = np.random.default_rng(len(kind))
    if kind == "normal":
        return rng.normal(size=N).astype(np.float32)
    if kind == "dup_heavy":
        return rng.choice(np.asarray([-3.0, -1.5, 0.0, 1e-3, 0.25, 1.0, 7.5,
                                      100.0], np.float32), size=N)
    if kind == "denormal":
        return rng.normal(size=N).astype(np.float32) * np.float32(1e-41)
    if kind == "ulp_wide":
        return (rng.normal(size=N).astype(np.float32)
                * np.exp2(rng.integers(-120, 120, size=N)).astype(np.float32))
    ts = rng.normal(size=N).astype(np.float32)  # tie_storm
    ts[: N // 2] = np.float32(0.5)
    return rng.permutation(ts)


REGIMES = ["normal", "dup_heavy", "denormal", "ulp_wide", "tie_storm"]
KS = np.clip(np.ceil(np.asarray(KS_FRACS) * N), 1, N).astype(np.int32)


def _port(x, dtype=None):
    t = from_numpy(x, device="cpu")
    return t if dtype is None else t.to(dtype)


def _bits(t):
    a = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _subnormal(t):
    a = t.float().numpy()
    return (a != 0) & (np.abs(a) < TINY)


def assert_same_result(got, ref):
    """Every field equal, bit for bit, dtype included — except, for a
    target whose bracket the port narrowed into the subnormal range (a tie
    class at 0.0), the sweep count and bracket: the jitted reference
    flushes subnormal edges to zero and stops sooner (ROADMAP Queue 3)."""
    want = select_result_from_numpy(
        type(ref)(*(np.asarray(f) for f in ref)), device="cpu")
    flushed = _subnormal(got.y_lo) | _subnormal(got.y_hi)
    for name in FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, (name, g.dtype, w.dtype)
        keep = ~flushed if name in ("iters", "y_lo", "y_hi") else slice(None)
        np.testing.assert_array_equal(_bits(g)[keep], _bits(w)[keep],
                                      err_msg=name)


def _partition(x, ks):
    xs = np.sort(np.asarray(x, np.float32))
    return xs[np.asarray(ks) - 1]


def _ref_multi(x, ks, **kw):
    return jsel.multi_order_statistic(jnp.asarray(x), jnp.asarray(ks),
                                      backend="jnp", **kw)


# ---------------------------------------------------------------------------
# the engine: binned leg every field, cp leg values
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("regime", REGIMES)
def test_binned_matches_reference(regime):
    x = _regime(regime)
    got = tsel.multi_order_statistic(_port(x), torch.as_tensor(KS),
                                     method="binned")
    np.testing.assert_array_equal(got.value.numpy(), _partition(x, KS))
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)
    if regime != "denormal":
        assert_same_result(got, _ref_multi(x, KS, method="binned"))


@pytest.mark.parametrize("regime", REGIMES)
def test_cp_values_exact(regime):
    """The cp leg's pivots come from f32 sums taken in another order than
    the reference's, so only the values are held (against np.partition).
    Kelley cuts move by value: over the 240 binades of ``ulp_wide`` they
    need ~220 passes, and both engines return NOT_CONVERGED at the default
    ``maxit=64`` (ROADMAP Queue 3)."""
    x = _regime(regime)
    got = tsel.multi_order_statistic(_port(x), torch.as_tensor(KS),
                                     method="cp",
                                     maxit=256 if regime == "ulp_wide" else 64)
    np.testing.assert_array_equal(got.value.numpy(), _partition(x, KS))
    assert np.all(got.status.numpy() != tsel.NOT_CONVERGED)


def test_bf16_binned_matches_reference_and_cp_is_exact():
    """bf16 data, f32 brackets.  The reference raises on the cp family for
    bf16 (ROADMAP Queue 3); the port's cp answers equal np.partition's."""
    x32 = _regime("normal")
    xb = _port(x32, torch.bfloat16)
    xb_vals = xb.float().numpy()
    got = tsel.multi_order_statistic(xb, torch.as_tensor(KS),
                                     method="binned")
    assert_same_result(got, _ref_multi(jnp.asarray(x32, jnp.bfloat16), KS,
                                       method="binned"))
    np.testing.assert_array_equal(got.value.float().numpy(),
                                  _partition(xb_vals, KS))
    got = tsel.multi_order_statistic(xb, torch.as_tensor(KS), method="cp")
    np.testing.assert_array_equal(got.value.float().numpy(),
                                  _partition(xb_vals, KS))


def test_log1p_matches_reference():
    """1e20-scale components: sweeps on the log1p image, brackets mapped
    back pivot by pivot, answers exact."""
    x = _regime("normal")
    x[:16] = 1e20
    got = tsel.multi_order_statistic(_port(x), torch.as_tensor(KS),
                                     method="binned", transform="log1p")
    np.testing.assert_array_equal(got.value.numpy(), _partition(x, KS))
    assert_same_result(got, _ref_multi(x, KS, method="binned",
                                       transform="log1p"))
    got = tsel.multi_order_statistic(_port(x), torch.as_tensor(KS),
                                     method="cp", transform="log1p")
    np.testing.assert_array_equal(got.value.numpy(), _partition(x, KS))


def test_sort_method_matches_reference():
    x = _regime("tie_storm")
    got = tsel.multi_order_statistic(_port(x), torch.as_tensor(KS),
                                     method="sort")
    assert_same_result(got, _ref_multi(x, KS, method="sort"))


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_k1_equals_order_statistic(method):
    """K = 1 on the shared evaluator is the B = 1 rows problem: every field
    equal at the same cap."""
    x = _regime("dup_heavy")
    for k in (1, 2345, N):
        got = tsel.multi_order_statistic(_port(x), [k], method=method,
                                         cap=64)
        want = tsel.order_statistic(_port(x), k, method=method, cap=64)
        for name in FIELDS:
            np.testing.assert_array_equal(
                _bits(getattr(got, name)), _bits(getattr(want, name)[None]),
                err_msg=name)


def test_quantiles_match_reference():
    x = _regime("normal")
    qs = np.asarray(KS_FRACS)
    got = tsel.quantiles(_port(x), qs, method="binned")
    ref = jsel.quantiles(jnp.asarray(x), qs, method="binned", backend="jnp")
    assert_same_result(got, ref)
    auto = tsel.quantiles(_port(x), qs)  # n < 65536: the cp leg
    np.testing.assert_array_equal(auto.value.numpy(), _partition(x, KS))


def test_strided_view_and_unported_options():
    x = _regime("normal")
    xt = _port(np.repeat(x, 2))
    got = tsel.multi_order_statistic(xt[::2], torch.as_tensor(KS))
    np.testing.assert_array_equal(got.value.numpy(), _partition(x, KS))
    with pytest.raises(ValueError):
        tsel.quantiles(xt, [0.5], transform="nope")


# ---------------------------------------------------------------------------
# the plain K3/K4 versions
# ---------------------------------------------------------------------------


def _special_data(rng, n):
    x = rng.standard_normal(n).astype(np.float32)
    idx = rng.choice(n, size=64, replace=False)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-44,
                        1e-39, -3e-39, 3e38, -3e38], np.float32)
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


def _ftz(a):
    return np.where(np.abs(a) < TINY, np.float32(0), a).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_match_reference(dtype):
    """Counts bit for bit against ``repro.kernels.ref`` (jitted, denormals
    flushed first, as the reference flushes them); sums within SUM_RTOL."""
    rng = np.random.default_rng(1)
    x = _ftz(_special_data(rng, 8192))
    edges = _ladders(16)
    xt = _port(x, getattr(torch, dtype))
    xj = jnp.asarray(x, getattr(jnp, dtype))
    cnt_j, _ = jax.jit(lambda a, e: jref.cp_histogram_multi_ref(
        a, e, impl="searchsorted", want_sums=False))(xj, jnp.asarray(edges))
    cnt_t, bsum_t = tref.cp_histogram_multi_ref(xt, _port(edges),
                                                want_sums=False)
    assert bsum_t is None and cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert np.all(cnt_t.numpy().sum(axis=1) == x.size)

    y = np.array([0.0, 1.0, -0.5, 3e38, float(x[100])], np.float32)
    want = jax.jit(jref.cp_partials_multi_ref)(xj, jnp.asarray(y))
    got = tref.cp_partials_multi_ref(xt, _port(y))
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):  # NaN data: both sums NaN
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    finite = x[np.isfinite(x)]
    got = tref.cp_partials_multi_ref(_port(finite, getattr(torch, dtype)),
                                     _port(y[:3]))
    want = jref.cp_partials_multi_ref(
        jnp.asarray(finite, getattr(jnp, dtype)), jnp.asarray(y[:3]))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL)


def test_plain_versions_match_pallas_interpret():
    """The TPU bodies K3 and K4 replace, in interpret mode at one small
    NaN-free input each (the Pallas histogram counts NaN in no slot)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(3000).astype(np.float32)
    x[:4] = [np.inf, -np.inf, 2.0, -2.0]
    edges = _ladders(16)
    cnt_p, _ = jcp.cp_histogram_multi(jnp.asarray(x), jnp.asarray(edges),
                                      block_rows=8, interpret=True,
                                      want_sums=False)
    cnt_t, _ = tref.cp_histogram_multi_ref(_port(x), _port(edges),
                                           want_sums=False)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_p))
    xf = x[4:]
    y = np.array([0.1, float(xf[7]), -1.0], np.float32)
    want = jcp.cp_partials_multi(jnp.asarray(xf), jnp.asarray(y),
                                 block_rows=8, interpret=True)
    got = tref.cp_partials_multi_ref(_port(xf), _port(y))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL)


def test_k1_views_on_the_cpu():
    """``fused_histogram`` / ``fused_partials`` are row 0 of the multi
    passes; off the card every kernel wrapper raises and none launches."""
    rng = np.random.default_rng(5)
    x = _port(_special_data(rng, 5000))
    edges = _port(_ladders(16))
    cnt, _ = ops.fused_histogram_multi(x, edges)
    one, none = ops.fused_histogram(x, edges[2])
    assert none is None and torch.equal(one, cnt[2])
    y = torch.tensor([0.5, -1.0])
    multi = ops.fused_partials_multi(x, y)
    for a, b in zip(ops.fused_partials(x, -1.0), multi):
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())
    cp_objective.reset_launches()
    for call in (lambda: cp_objective.cp_histogram_multi(x, edges),
                 lambda: cp_objective.cp_histogram(x, edges[0]),
                 lambda: cp_objective.cp_partials_multi(x, y),
                 lambda: cp_objective.cp_partials(x, 0.5)):
        with pytest.raises(ValueError):
            call()
    tsel.quantiles(x, [0.1, 0.9])
    assert not any(cp_objective.LAUNCHES.values())


# ---------------------------------------------------------------------------
# structure: no (K, n) tensor, and the sweeps are shared
# ---------------------------------------------------------------------------


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


def test_quantiles_never_materialize_k_by_n():
    n, k = 1 << 17, 8
    x = _port(np.random.default_rng(6).standard_normal(n).astype(np.float32))
    qs = np.linspace(0.05, 0.95, k)
    with _LargestOutput() as mode:
        res = tsel.quantiles(x, qs)  # n >= 65536: the binned leg
    assert n <= mode.largest < k * n, mode.largest
    np.testing.assert_array_equal(
        res.value.numpy(),
        _partition(x.numpy(), tsel.ranks_from_quantiles(qs, n).numpy()))


def test_sweep_sharing_economy():
    """K = 16 quantiles narrow from the SAME sweeps: at most twice the
    sweeps of one binned median (``test_multi_k.py``'s bound)."""
    x = _port(np.random.default_rng(11).normal(size=1 << 17)
              .astype(np.float32))
    s1 = int(tsel.median(x, method="binned").iters)
    res = tsel.quantiles(x, np.arange(1, 17) / 17.0, method="binned")
    s16 = int(res.iters.max())
    assert s16 <= max(2 * s1, s1 + 1), (s1, s16)
