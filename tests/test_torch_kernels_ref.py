"""The port's plain kernel versions held against the JAX reference.

``repro_torch.kernels.ref`` computes what the CUDA kernels K1 (histogram)
and K2 (partials) compute; here it meets ``repro.kernels.ref`` (jitted, as
the reference engine runs it) and the reference's Pallas bodies in
interpret mode on the same numpy inputs.  Counts and edges must agree bit
for bit; f32 sums are taken in another order, so they agree within
``SUM_RTOL``.

Denormals: under ``jit`` XLA:CPU flushes denormal inputs and results to
zero, the port (and the GPU kernels, built without fast-math) does not.
Where a regime has denormals the reference is held against the port under
an explicit flush, and the port against an exact numpy construction.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import cp_objective as jcp  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# f32 sums of up to 2^17 same-sign terms, reduced in another order: the
# relative error of either order is below n * 2^-24 ~ 8e-3 in the worst
# case and ~sqrt(n) * 2^-24 ~ 2e-5 for these random inputs.
SUM_RTOL = 1e-4
TINY = np.finfo(np.float32).tiny

_jit_bin_edges = jax.jit(jref.bin_edges, static_argnums=2)
_jit_slots = jax.jit(jref.searchsorted_slots)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _ftz(a):
    a = np.asarray(a, np.float32)
    return np.where(np.abs(a) < TINY, np.float32(0), a)


def _special_data(rng, shape):
    """Normal data with ±inf, NaN, signed zeros and denormals planted."""
    x = rng.standard_normal(shape).astype(np.float32)
    flat = x.reshape(-1)
    idx = rng.choice(flat.size, size=min(64, flat.size), replace=False)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-44,
                        1e-39, -3e-39, 3e38, -3e38], np.float32)
    flat[idx] = special[np.arange(idx.size) % special.size]
    return x


# ---------------------------------------------------------------------------
# bin_edges
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nbins", [1, 2, 16, 100, 128])
def test_bin_edges_bits_normal_brackets(nbins):
    rng = np.random.default_rng(nbins)
    lo = (rng.standard_normal(2048) * 10.0 ** rng.integers(-6, 6, 2048)
          ).astype(np.float32)
    hi = (lo + np.abs(rng.standard_normal(2048)) * 10.0 ** rng.integers(
        -6, 6, 2048)).astype(np.float32)
    want = np.asarray(_jit_bin_edges(jnp.asarray(lo), jnp.asarray(hi), nbins))
    got = tref.bin_edges(_t(lo), _t(hi), nbins).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("nbins", [1, 2, 16, 128])
def test_bin_edges_bits_full_range_and_degenerate(nbins):
    """±3e38 / ±f32max (width overflows), lo == hi, infinite ends and a
    one-ulp bracket (duplicated edges)."""
    fmax = np.finfo(np.float32).max
    one_up = np.nextafter(np.float32(1), np.float32(2))
    lo = np.array([-3e38, -fmax, 1.0, -np.inf, 0.0, 1.0, -fmax, 2.5],
                  np.float32)
    hi = np.array([3e38, fmax, 1.0, 1.0, np.inf, one_up, -1e38, 2.5],
                  np.float32)
    want = np.asarray(_jit_bin_edges(jnp.asarray(lo), jnp.asarray(hi), nbins))
    got = tref.bin_edges(_t(lo), _t(hi), nbins).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.all(got[:, 1:] >= got[:, :-1])
    np.testing.assert_array_equal(got[:, 0], lo)
    np.testing.assert_array_equal(got[:, -1], hi)


@pytest.mark.parametrize("nbins", [1, 16, 128])
def test_bin_edges_denormal_brackets(nbins):
    """The port's edges are the exact single-rounding construction; the
    jitted reference equals them once inputs and outputs are flushed."""
    lo = np.array([-1e-40, 0.0, 1e-45, -1e-38, 1e-44, -5e-39], np.float32)
    hi = np.array([1e-40, 1e-41, 1e-44, 1e-38, 1e-38, -1e-39], np.float32)
    got = tref.bin_edges(_t(lo), _t(hi), nbins).numpy()
    c = np.float32(1) / np.float32(nbins)
    w = np.clip((hi.astype(np.float64) * c - (lo * c).astype(np.float64)
                 ).astype(np.float32), 0, None)
    e = (lo[:, None].astype(np.float64) + w[:, None].astype(np.float64)
         * np.arange(nbins + 1)).astype(np.float32)
    e = np.minimum(np.maximum(e, lo[:, None]), hi[:, None])
    e[:, -1] = hi
    np.testing.assert_array_equal(_bits(got), _bits(e))
    assert np.any((got != 0) & (np.abs(got) < TINY))  # denormals kept
    want = np.asarray(_jit_bin_edges(jnp.asarray(lo), jnp.asarray(hi), nbins))
    flushed = tref.bin_edges(_t(_ftz(lo)), _t(_ftz(hi)), nbins).numpy()
    # the last edge is ``hi`` itself, passed through without arithmetic
    np.testing.assert_array_equal(_ftz(flushed)[:, :-1], want[:, :-1])
    np.testing.assert_array_equal(_bits(want[:, -1]), _bits(hi))


# ---------------------------------------------------------------------------
# searchsorted_slots and the histogram
# ---------------------------------------------------------------------------


def _edge_rows(rng, b, nbins):
    """Per-row edge ladders: data-scale, full-range, a duplicated
    (one-ulp) ladder and a ladder through the data's bulk."""
    kinds = [(-2.0, 2.0), (-3e38, 3e38),
             (0.25, float(np.nextafter(np.float32(0.25), np.float32(1)))),
             (-0.5, 0.75)]
    lo = np.array([kinds[i % 4][0] for i in range(b)], np.float32)
    hi = np.array([kinds[i % 4][1] for i in range(b)], np.float32)
    return tref.bin_edges(_t(lo), _t(hi), nbins).numpy()


def test_searchsorted_nan_goes_to_top_slot():
    """torch.searchsorted walks NaN right; the oracle pins it there."""
    e = torch.tensor([0.0, 1.0, 2.0])
    x = torch.tensor([float("nan"), float("-inf"), float("inf"), 1.0, 0.0,
                      -0.0])
    assert torch.searchsorted(e, x, side="left")[0].item() == 3
    got = tref.searchsorted_slots(x, e)
    assert got.dtype == torch.int32
    assert got.tolist() == [3, 0, 3, 1, 0, 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_searchsorted_slots_match_reference(dtype):
    rng = np.random.default_rng(1)
    b, n, nbins = 8, 4096, 16
    x = _ftz(_special_data(rng, (b, n)))  # the reference flushes denormals
    edges = _edge_rows(rng, b, nbins)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    xt = _t(x).to(getattr(torch, dtype))
    want = np.asarray(_jit_slots(xj.astype(jnp.float32), jnp.asarray(edges)))
    got = tref.searchsorted_slots(xt, _t(edges)).numpy()
    np.testing.assert_array_equal(got, want)
    # NaN data lands in the top slot on both
    assert np.all(got[np.isnan(x)] == nbins + 1)


def test_searchsorted_slots_denormals_exact():
    """Denormal data between denormal edges: the port bins by exact IEEE
    comparison (numpy's), which the flushing reference cannot."""
    x = np.array([-1e-44, 0.0, 1e-45, 2e-45, 1e-44, 5e-39, 2e-38, np.nan],
                 np.float32)
    edges = np.array([-2e-45, 1e-45, 1e-44, 1e-38], np.float32)
    got = tref.searchsorted_slots(_t(x), _t(edges)).numpy()
    want = np.searchsorted(edges, x, side="left")
    want[np.isnan(x)] = edges.size
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["searchsorted", "arithmetic"])
def test_histogram_counts_match_reference(dtype, impl):
    rng = np.random.default_rng(2)
    b, n, nbins = 8, 8192, 16
    x = _ftz(_special_data(rng, (b, n)))
    edges = _edge_rows(rng, b, nbins)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    cnt_j, _ = jax.jit(lambda a, e: jref.cp_histogram_batched_ref(
        a, e, impl=impl, want_sums=False))(xj, jnp.asarray(edges))
    xt = _t(x).to(getattr(torch, dtype))
    cnt_t, bsum_t = tref.cp_histogram_batched_ref(xt, _t(edges),
                                                  want_sums=False)
    assert bsum_t is None
    assert cnt_t.dtype == torch.int32
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    assert np.all(cnt_t.numpy().sum(axis=1) == n)


def test_histogram_sums_match_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1 << 17)).astype(np.float32)
    edges = _edge_rows(rng, 4, 128)
    edges[1] = edges[0]  # a finite ladder in place of the full-range row
    cnt_j, bsum_j = jax.jit(lambda a, e: jref.cp_histogram_batched_ref(
        a, e, impl="searchsorted"))(jnp.asarray(x), jnp.asarray(edges))
    cnt_t, bsum_t = tref.cp_histogram_batched_ref(_t(x), _t(edges))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))
    np.testing.assert_allclose(bsum_t.numpy(), np.asarray(bsum_j),
                               rtol=SUM_RTOL, atol=1e-3)
    c1, s1 = tref.cp_histogram_ref(_t(x[0]), _t(edges[0]))
    np.testing.assert_array_equal(c1.numpy(), cnt_t.numpy()[0])
    np.testing.assert_array_equal(s1.numpy(), bsum_t.numpy()[0])


def test_histogram_counts_match_pallas_interpret():
    """The TPU body K1 replaces, run in interpret mode at one small
    NaN-free shape (the Pallas body counts NaN in no slot)."""
    rng = np.random.default_rng(4)
    b, n, nbins = 2, 2000, 16
    x = rng.standard_normal((b, n)).astype(np.float32)
    x[0, :4] = [np.inf, -np.inf, 2.0, -2.0]
    edges = _edge_rows(rng, b, nbins)
    cnt_p, _ = jcp.cp_histogram_batched(jnp.asarray(x), jnp.asarray(edges),
                                        block_rows=8, interpret=True,
                                        want_sums=False)
    cnt_t, _ = tref.cp_histogram_batched_ref(_t(x), _t(edges),
                                             want_sums=False)
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_p))


# ---------------------------------------------------------------------------
# partials
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partials_match_reference(dtype):
    rng = np.random.default_rng(5)
    b, n = 8, 1 << 14
    x = rng.standard_normal((b, n)).astype(np.float32)
    x[:, :100] = np.round(x[:, :100])  # ties at integer pivots
    y = np.array([0.0, 1.0, -1.0, 0.5, 3e38, -3e38, 1e-3, x[7, 500]],
                 np.float32)
    xj = jnp.asarray(x, getattr(jnp, dtype))
    want = jax.jit(jref.cp_partials_batched_ref)(xj, jnp.asarray(y))
    xt = _t(x).to(getattr(torch, dtype))
    got = tref.cp_partials_batched_ref(xt, _t(y))
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL)
    one = tref.cp_partials_ref(xt[3], float(y[3]))
    for g, w in zip(one, got):
        np.testing.assert_allclose(g.numpy(), w.numpy()[3], rtol=SUM_RTOL)


def test_partials_nan_and_inf_match_reference():
    """NaN data and inf - inf propagate NaN into both sums and count in
    neither count, on both sides."""
    x = np.array([[np.nan, 1.0, -1.0, 0.0, np.inf, -np.inf]] * 2,
                 np.float32)
    y = np.array([0.5, np.inf], np.float32)
    want = jax.jit(jref.cp_partials_batched_ref)(jnp.asarray(x),
                                                 jnp.asarray(y))
    got = tref.cp_partials_batched_ref(_t(x), _t(y))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isnan(got[0].numpy()).all()
    assert got[2].tolist() == [3, 4] and got[3].tolist() == [3, 4]


def test_partials_counts_match_pallas_interpret():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3000)).astype(np.float32)
    y = np.array([0.1, float(x[1, 7])], np.float32)
    want = jcp.cp_partials_batched(jnp.asarray(x), jnp.asarray(y),
                                   block_rows=8, interpret=True)
    got = tref.cp_partials_batched_ref(_t(x), _t(y))
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=SUM_RTOL)
