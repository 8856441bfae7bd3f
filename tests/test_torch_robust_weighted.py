"""The port's weighted-median regressions (``theil_sen_fit``,
``irls_fit``) held against the JAX reference.

Same numpy inputs through ``repro.core.robust`` (on its CPU jnp path) and
the port on the CPU (``device="cpu"``):

* ``theil_sen_fit`` at n = 1500: 'uniform' bit for bit (full), the blocked
  mode with ``max_pairs = n(n-1)`` equal to the full one and with 64n
  pairs equal to the median of its own slopes, a warm refit = cold; 'sen'
  cold and warm inside the f64 mass interval of a sort + cumulative-mass
  oracle;
* ``irls_fit`` (Huber, Tukey): parameters within 1e-5 of the reference,
  the sweeps equal, the last 4 iterations 1 sweep each; its scale is a
  weighted median of residuals that cancel to ~0.06, so it moves ~1e-4
  with the parameters' last bits (the two packages' BLAS round the
  normal equations differently): the port's weighted median reproduces
  the reference's scale bit for bit on the reference's own final
  residuals and weights; warm within 1e-5 of cold.

With dense weights (Sen's |dx|, IRLS's robustness weights) the masses
round, and a warm solve, whose final bracket differs, may return the
adjacent value inside the mass interval (the reference's warm Theil-Sen
refit does on the data here), so warm = cold is held bit for bit only
where the masses are exact ('uniform').
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import robust as jrob  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import robust as trob  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process (the suite runs its files in
    parallel processes); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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
# Theil-Sen
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ts_case():
    rng = np.random.default_rng(22)
    n = 1500
    x = rng.standard_normal(n).astype(np.float32)
    y = (1.5 * x - 0.5 + 0.05 * rng.standard_normal(n)).astype(np.float32)
    y[rng.random(n) < 0.2] += 40.0  # gross contamination
    return x, y


def test_theil_sen_uniform_equals_reference(ts_case):
    """'uniform': the full mode bit for bit; the blocked mode at
    ``max_pairs = n(n-1)`` (every ordered pair once) equals the full one,
    and at 64n pairs its slope is the median of its own slopes; a warm
    refit equals the cold fit."""
    x, y = ts_case
    n = x.size
    want = jrob.theil_sen_fit(jnp.asarray(x), jnp.asarray(y),
                              weighting="uniform")
    got = trob.theil_sen_fit(_t(x), _t(y), weighting="uniform")
    _same(got.theta, want.theta)
    every = trob.theil_sen_fit(_t(x), _t(y), weighting="uniform",
                               max_pairs=n * (n - 1))
    assert torch.equal(every.theta, got.theta)
    blocked = trob.theil_sen_fit(_t(x), _t(y), weighting="uniform",
                                 max_pairs=64 * n)
    offs = trob._pair_offsets(n, 64 * n)
    idx = (np.arange(n)[None, :] + offs[:, None]) % n
    dx, dy = x[idx] - x[None, :], y[idx] - y[None, :]
    s = np.sort((dy / np.where(dx != 0, dx, 1))[dx != 0])
    assert float(blocked.slope) == s[(s.size + 1) // 2 - 1]
    for fit in (got, blocked):
        warm = trob.theil_sen_fit(_t(x), _t(y), weighting="uniform",
                                  max_pairs=None if fit is got else 64 * n,
                                  prior=fit)
        assert torch.equal(warm.theta, fit.theta)


def _sen_mass_interval(x, y):
    """The f64 mass oracle of Sen's weighted median: the sorted slopes
    whose cumulative |dx| mass comes within ``slack`` of half the total.
    The engine's masses are f32 sums (per slot, then prefixes), whose
    rounding grows like a random walk: sqrt(m) * 2^-24 of the total for
    m ~ n^2 / 16 terms a slot, about 2^-15 here."""
    dx = (x[None, :] - x[:, None]).astype(np.float32)
    valid = dx != 0
    s = np.where(valid, (y[None, :] - y[:, None]).astype(np.float32)
                 / np.where(valid, dx, 1), 0).astype(np.float32).ravel()
    w = np.where(valid, np.abs(dx), 0).astype(np.float64).ravel()
    order = np.argsort(s, kind="stable")
    cum = np.cumsum(w[order])
    half, slack = cum[-1] / 2, cum[-1] * 2.0 ** -15
    lo = s[order][np.searchsorted(cum, half - slack)]
    hi = s[order][min(np.searchsorted(cum, half + slack), cum.size - 1)]
    return lo, hi


def test_theil_sen_sen_inside_the_mass_interval(ts_case):
    """'sen' (dense |dx| weights): the cold slope and a warm refit's (from
    the cold (slope, intercept) pair) inside the f64 mass interval.  With
    dense weights a warm answer may be the adjacent slope inside the
    interval (its final bracket differs, so its masses round differently;
    the reference's warm refit moves on this input too), so warm = cold is
    held bit for bit on 'uniform' only."""
    x, y = ts_case
    got = trob.theil_sen_fit(_t(x), _t(y))
    lo, hi = _sen_mass_interval(x, y)
    warm = trob.theil_sen_fit(_t(x), _t(y), prior=(got.slope, got.intercept))
    for slope in (got.slope, warm.slope):
        assert lo <= float(slope) <= hi, (lo, float(slope), hi)


# ---------------------------------------------------------------------------
# IRLS
# ---------------------------------------------------------------------------


def _irls_case(n=1 << 14):
    rng = np.random.default_rng(20)
    x = rng.standard_normal(n).astype(np.float32)
    X = np.stack([np.ones_like(x), x], axis=1)
    y = (2.0 + 3.0 * x + 0.1 * rng.standard_normal(n)).astype(np.float32)
    out = rng.random(n) < 0.2  # 20% gross contamination
    y = np.where(out, 50.0 * rng.standard_normal(n).astype(np.float32), y)
    return X, y


@pytest.mark.parametrize("loss", ["huber", "tukey"])
def test_irls_equals_reference(loss):
    X, y = _irls_case()
    Xj, yj = jnp.asarray(X), jnp.asarray(y)
    ref = jrob.irls_fit(Xj, yj, loss=loss, iters=8, method="binned")
    warm = trob.irls_fit(_t(X), _t(y), loss=loss, iters=8, method="binned")
    cold = trob.irls_fit(_t(X), _t(y), loss=loss, iters=8, method="binned",
                         warm=False)
    assert _rel(warm.theta.numpy(), ref.theta) <= 1e-5
    assert _rel(cold.theta.numpy(), warm.theta.numpy()) <= 1e-5
    sw = warm.sweeps.numpy()
    assert np.all(np.diff(sw) <= 0) and np.all(sw[-4:] == 1), sw
    assert np.all(sw <= cold.sweeps.numpy())
    np.testing.assert_array_equal(sw, np.asarray(ref.sweeps))
    # the scale step on the reference's own final residuals and weights:
    # the port's weighted median gives the reference's scale bit for bit
    th = np.asarray(ref.theta)
    rj = yj - Xj @ jnp.asarray(th)
    wj = jrob._rho_weights(rj / ref.scale, loss,
                           1.345 if loss == "huber" else 4.685)
    jmad = jsel.weighted_median(jnp.abs(rj), wj, method="binned").value
    tmad = tsel.weighted_median(_t(np.abs(np.asarray(rj))),
                                _t(np.asarray(wj)), method="binned").value
    _same(tmad, jmad)
