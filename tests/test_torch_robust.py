"""The port's LTS, LMS and kNN (``repro_torch.core.robust``) held against
the JAX reference.

Same numpy inputs through ``repro.core.robust`` (on its CPU jnp path) and
the port on the CPU (``device="cpu"``).  The reference's elemental starts
come from ``jax.random``, which the port cannot reproduce, so the LTS and
LMS fits run from the reference's starts (``_elemental_thetas`` as
numpy).  Matrix products round differently in the two packages' BLAS, so
fitted parameters are held within a tolerance, and bit for bit only where
the inputs of a selection are the same bits:

* ``lts_objective_rows``, ``_lts_weights_rows`` and ``select_rows`` under
  ``_nan_prior`` (the first warm step) on the same residual block:
  weights and every result field bit for bit, the objective bit for bit
  on quarter-integer residuals and within 1e-6 on randn;
* ``lts_fit`` / ``lms_fit`` at n = 2048, p = 4, 30% outliers: parameters
  within 1e-4, objectives within 1e-5, outliers weighted 0, warm = cold in
  the port bit for bit, and the first step's sweeps equal where the
  residual rows are the same bits;
* ``knn_predict`` on integer coordinates (d2 exact in f32): regression
  (pairs of points at each location, so the tie weights are dyadic and
  every sum exact) and classification bit for bit.

The Theil-Sen and IRLS fits are in ``test_torch_robust_weighted.py``, the
gradient-pytree functions in ``test_torch_robust_clip.py``: each file
pays its own reference compiles.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import robust as jrob  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import robust as trob  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402

from test_robust import make_regression  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process (the suite runs its files in
    parallel processes); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = ("value", "iters", "status", "y_lo", "y_hi", "n_in")
N_FIT, P_FIT = 2048, 4


def _t(a):
    return from_numpy(np.ascontiguousarray(a), device="cpu")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(got, want):
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


# ---------------------------------------------------------------------------
# the LTS pieces on one residual block
# ---------------------------------------------------------------------------


def _residual_block(kind):
    rng = np.random.default_rng(1)
    if kind == "quarter":
        # squares are sixteenths below 256: every sum of 2051 is exact
        return (rng.integers(-64, 65, (6, 4099)) / 4).astype(np.float32)
    return rng.standard_normal((6, 4099)).astype(np.float32)


@pytest.mark.parametrize("kind", ["quarter", "randn"])
def test_lts_pieces_equal_reference(kind):
    R = _residual_block(kind)
    h = 2051
    Rj, Rt = jnp.asarray(R), _t(R)
    # the first warm step of a fit: the binned leg (the cp leg's brackets
    # follow the last bits of each row's sums) under the all-NaN prior,
    # one reference compile for the three calls
    pj = jrob._nan_prior((6,), jnp.float32)
    pt = trob._nan_prior((6,), torch.float32)
    Wj, rj = jrob._lts_weights_rows(Rj, h, "binned", prior=pj)
    Wt, rt = trob._lts_weights_rows(Rt, h, "binned", prior=pt)
    _same(Wt, Wj)
    for name in FIELDS:
        _same(getattr(rt, name), getattr(rj, name))
    st = tsel.select_rows(Rt * Rt, h, method="binned", prior=pt)
    for name in FIELDS:
        _same(getattr(st, name), getattr(rj, name))
    oj = np.asarray(jrob.lts_objective_rows(Rj, h, method="binned",
                                            prior=pj))
    ot = trob.lts_objective_rows(Rt, h, method="binned", prior=pt)
    want = np.sort(R.astype(np.float64) ** 2, axis=1)[:, :h].sum(axis=1)
    if kind == "quarter":
        _same(ot, oj)
        np.testing.assert_array_equal(ot.numpy(), want)
    else:
        np.testing.assert_allclose(ot.numpy(), oj, rtol=1e-6, atol=0)
        np.testing.assert_allclose(ot.numpy(), want, rtol=1e-5, atol=0)


# ---------------------------------------------------------------------------
# LTS and LMS fits from the reference's starts
# ---------------------------------------------------------------------------


N_STARTS = 16
_jit_starts = jax.jit(jrob._elemental_thetas, static_argnums=3)


@pytest.fixture(scope="module")
def fit_case():
    X, y, theta, out = make_regression(np.random.default_rng(1), n=N_FIT,
                                       p=P_FIT)
    return X, y, theta, out


def _starts(key, X, y):
    """The reference's elemental starts, as numpy (one compile)."""
    return np.asarray(_jit_starts(key, jnp.asarray(X), jnp.asarray(y),
                                  N_STARTS))


def test_lts_fit_equals_reference(fit_case):
    X, y, theta, out = fit_case
    key = jax.random.PRNGKey(0)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    starts = _starts(key, X, y)
    ref = jrob.lts_fit(key, Xj, yj, n_starts=N_STARTS, c_steps=6,
                       method="binned")
    h = (N_FIT + P_FIT + 1) // 2
    warm = trob._concentrate(_t(starts), _t(X), _t(y), h, 6, "binned", True)
    cold = trob._concentrate(_t(starts), _t(X), _t(y), h, 6, "binned",
                             False)
    assert _rel(warm.theta.numpy(), ref.theta) <= 1e-4
    assert abs(float(warm.objective) - float(ref.objective)) <= \
        1e-5 * abs(float(ref.objective))
    assert np.linalg.norm(warm.theta.numpy() - theta) < 0.05
    assert float(warm.inlier_weights[out].sum()) == 0.0
    assert float(np.asarray(ref.inlier_weights)[out].sum()) == 0.0
    for name in ("theta", "objective", "inlier_weights"):
        assert torch.equal(getattr(warm, name), getattr(cold, name)), name
    # the first step's residual rows: where they are the same bits in both
    # packages, so are that step's sweeps
    R0j = np.asarray(jnp.asarray(starts) @ Xj.T - yj[None, :])
    R0t = (_t(starts) @ _t(X).T - _t(y)[None, :]).numpy()
    same = np.all(_bits(R0j) == _bits(R0t), axis=1)
    assert same.sum() >= 8
    sw = np.asarray(ref.sweeps)
    assert warm.sweeps.shape == sw.shape
    np.testing.assert_array_equal(warm.sweeps.numpy()[0][same], sw[0][same])
    # warm steps after the first re-certify in one sweep somewhere (the
    # first warm step may take more sweeps than the cold one: the all-NaN
    # prior's edges are not the cold layout, in the reference too)
    assert np.any(warm.sweeps.numpy()[1:] == 1)


def test_lms_fit_equals_reference(fit_case):
    X, y, theta, _ = fit_case
    key = jax.random.PRNGKey(1)
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    starts = _starts(key, X, y)
    ref = jrob.lms_fit(key, Xj, yj, n_starts=N_STARTS)
    got = trob._lms_from_starts(_t(starts), _t(X), _t(y), None)
    assert _rel(got.theta.numpy(), ref.theta) <= 1e-4
    assert abs(float(got.objective) - float(ref.objective)) <= \
        1e-5 * abs(float(ref.objective))
    # the objective is the median of the chosen start's squared residuals
    r2 = (_t(X) @ got.theta - _t(y)) ** 2
    assert float(got.objective) <= float(
        torch.sort(((_t(starts) @ _t(X).T - _t(y)) ** 2)[0]).values[
            (N_FIT + 1) // 2 - 1])
    assert float(tsel.median(r2).value) == float(
        torch.sort(r2).values[(N_FIT + 1) // 2 - 1])


def test_fits_from_a_generator_are_seeded():
    """The port's own starts: a torch.Generator or an int seed; the same
    seed gives the same fit, and it recovers the truth."""
    X, y, theta, out = make_regression(np.random.default_rng(3), n=800,
                                       p=3)
    a = trob.lts_fit(7, _t(X), _t(y), n_starts=32, c_steps=4)
    b = trob.lts_fit(torch.Generator().manual_seed(7), _t(X), _t(y),
                     n_starts=32, c_steps=4)
    assert torch.equal(a.theta, b.theta)
    assert np.linalg.norm(a.theta.numpy() - theta) < 0.05
    assert float(a.inlier_weights[out].sum()) == 0.0
    m = trob.lms_fit(7, _t(X), _t(y), n_starts=64)
    assert np.linalg.norm(m.theta.numpy() - theta) < 0.2


# ---------------------------------------------------------------------------
# kNN
# ---------------------------------------------------------------------------


def test_knn_regression_and_classification_equal_reference():
    """One distance shape (40 queries, 4000 points), one reference
    compile."""
    rng = np.random.default_rng(4)
    # 1-D integer locations, two points at each: every cutoff has ties
    # (at least the pair), and the tie weights are dyadic, so every sum of
    # the prediction is exact
    loc = rng.choice(np.arange(-6000, 6000), 2000, replace=False)
    tx = np.repeat(loc, 2).astype(np.float32)[:, None]
    ty = rng.integers(-8, 9, tx.shape[0]).astype(np.float32)
    qx = rng.integers(-6000, 6000, (40, 1)).astype(np.float32)
    for k in (1, 7, 32):
        want = jrob.knn_predict(jnp.asarray(tx), jnp.asarray(ty),
                                jnp.asarray(qx), k)
        _same(trob.knn_predict(_t(tx), _t(ty), _t(qx), k), want)
    # 3-D integer coordinates, 3 classes
    tx3 = rng.integers(-12, 13, (4000, 3)).astype(np.float32)
    cls = rng.integers(0, 3, 4000).astype(np.int32)
    qx3 = rng.integers(-12, 13, (40, 3)).astype(np.float32)
    for k in (5, 32):
        want = jrob.knn_predict(jnp.asarray(tx3), jnp.asarray(cls),
                                jnp.asarray(qx3), k, classify=True,
                                n_classes=3)
        got = trob.knn_predict(_t(tx3), _t(cls), _t(qx3), k, classify=True,
                               n_classes=3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
