"""The port's gradient-pytree quantiles and clipping
(``repro_torch.core.robust``) held against the JAX reference.

Same numpy pytrees (nested dicts, lists, tuples and ``None``) through
``repro.core.robust`` and the port on the CPU: the leaves in
``jax.tree``'s order; per-leaf thresholds (one segmented solve) and
per-leaf clipping bit for bit; the global threshold (cutting-plane loop)
within ``tests/test_robust.py``'s tolerance of the reference's and of the
exact quantile; ``hist_quantile`` within one bin of the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import robust as jrob  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import robust as trob  # noqa: E402


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


# ---------------------------------------------------------------------------
# gradient pytrees
# ---------------------------------------------------------------------------


def _trees():
    rng = np.random.default_rng(3)
    tree = {
        "out": [rng.normal(size=(513,)).astype(np.float32) * np.float32(100),
                rng.normal(size=(33, 7)).astype(np.float32)
                * np.float32(0.01)],
        "embed": rng.normal(size=(256, 32)).astype(np.float32),
        "b": (rng.normal(size=(5,)).astype(np.float32), None),
    }
    to = lambda f, t: (  # noqa: E731
        {k: to(f, v) for k, v in t.items()} if isinstance(t, dict)
        else type(t)(to(f, v) for v in t) if isinstance(t, (list, tuple))
        else None if t is None else f(t))
    return to(jnp.asarray, tree), to(_t, tree)


def test_tree_order_is_jax_order():
    jt, tt = _trees()
    leaves, spec = trob._tree_flatten(tt)
    for a, b in zip(jax.tree.leaves(jt), leaves):
        _same(b, a)
    assert len(leaves) == len(jax.tree.leaves(jt))
    back = trob._tree_unflatten(spec, leaves)
    assert back["b"][1] is None and back["out"][1] is leaves[3]


@pytest.mark.parametrize("q", [0.5, 0.99])
def test_per_leaf_quantiles_and_clip_equal_reference(q):
    jt, tt = _trees()
    want = jax.tree.leaves(jrob.pytree_quantile_per_leaf(jt, q))
    got = trob._tree_flatten(trob.pytree_quantile_per_leaf(tt, q))[0]
    for g, w in zip(got, want):
        _same(g, w)
    cj, thj = jrob.clip_by_quantile(jt, q, per_leaf=True)
    ct, tht = trob.clip_by_quantile(tt, q, per_leaf=True)
    for g, w in zip(trob._tree_flatten(ct)[0] + trob._tree_flatten(tht)[0],
                    jax.tree.leaves(cj) + jax.tree.leaves(thj)):
        _same(g, w)


@pytest.mark.parametrize("q", [0.5, 0.99])
def test_global_and_hist_quantiles_match_reference(q):
    jt, tt = _trees()
    flat = np.abs(np.concatenate([np.asarray(v).ravel()
                                  for v in jax.tree.leaves(jt)]))
    k = int(np.ceil(q * flat.size))
    exact = np.partition(flat, k - 1)[k - 1]
    tol = lambda v: 1e-3 * max(1.0, abs(v))  # noqa: E731
    # the global threshold (16 cutting-plane passes, the clip's default)
    got = float(trob.pytree_quantile(tt, q))
    assert abs(got - exact) <= tol(exact)
    ct, thr = trob.clip_by_quantile(tt, q)
    cj, thj = jrob.clip_by_quantile(jt, q)
    assert float(thr) == max(got, 1e-8)
    assert abs(float(thr) - float(thj)) <= tol(float(thj))
    for g, leaf in zip(trob._tree_flatten(ct)[0], trob._tree_flatten(tt)[0]):
        assert torch.equal(g, torch.clamp(leaf, -thr, thr))
    # one bin of the 512 log-spaced bins over [min, max]
    hj = float(jrob.hist_quantile(jt, q))
    ht = float(trob.hist_quantile(tt, q))
    lo, hi = max(flat.min(), 1e-12), flat.max()
    ratio = np.exp((np.log(hi) - np.log(lo)) / 511)
    assert hj / ratio * (1 - 1e-6) <= ht <= hj * ratio * (1 + 1e-6)
    assert exact <= ht * (1 + 1e-6)
