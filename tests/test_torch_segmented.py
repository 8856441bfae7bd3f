"""The port's segmented selection held against the JAX reference.

Same numpy inputs through ``repro`` (its jnp path on the CPU, jitted as
its own tests run it) and the port on the CPU (``device="cpu"``):

* ``segmented_slots`` and ``segmented_histogram_ref`` bit for bit on
  interleaved segments with ±inf, NaN, ±0, duplicated edges and bf16
  (the per-slot sums on integer data, where every sum is exact in any
  order);
* ``segmented_order_statistic`` on the binned leg: every field equal, on
  interleaved and on contiguous segments, with constant, one-element and
  ±inf segments, f32 and bf16; on the cp leg ``value``, ``status`` and
  ``n_in`` (the pivots follow the last bits of the per-segment sums,
  which the port forms as a fixed tree and the reference sequentially, so
  ``iters``, ``y_lo`` and ``y_hi`` may differ); the ``sort`` leg; the
  ranks of ``segmented_quantiles``;
* ``eval_partials`` / ``eval_fg`` / ``eval_fg_batched`` bit for bit on
  integer data; ``FnEvaluator`` (counting and weighted, with and without
  the ``need_msum`` keyword) drives the engine as the evaluator it wraps;
* the port alone: a prior changes no value, and on dense randn (cp and
  ``binned_polish``, two and six torch threads) each segment solved alone
  equals its entry among eight in every field, and relabelling the
  segments changes nothing; ``GroupPlan`` sums a group the same alone as
  among others.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import objective as jobj  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.convert import from_numpy  # noqa: E402
from repro_torch.core import objective as tobj  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import cp_objective  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process (the suite runs its files in
    parallel processes); restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


FIELDS = ("value", "iters", "status", "y_lo", "y_hi", "n_in")
N = 1 << 16           # the binned leg (n >= BINNED_MIN_N)
N_CP = 50_000         # the auto cp leg

_jit_slots = jax.jit(jref.segmented_slots)
_jit_hist = jax.jit(jref.segmented_histogram_ref)
_jit_hist_sums = jax.jit(lambda x, seg, edges: jref.segmented_histogram_ref(
    x, seg, edges, rows=(x,)))


def _t(a):
    return from_numpy(np.ascontiguousarray(a), device="cpu")


def _bits(a):
    a = np.asarray(a)
    if a.dtype == np.float32:
        return a.view(np.int32)
    if a.dtype == jnp.bfloat16:
        return a.view(np.int16)
    return a


def _np(t):
    return _bits(t.view(torch.int16).numpy() if t.dtype == torch.bfloat16
                 else t.numpy())


def assert_fields(got, ref, fields=FIELDS):
    """The named fields equal, bit for bit, dtype included."""
    for name in fields:
        g, w = getattr(got, name), np.asarray(getattr(ref, name))
        assert str(g.dtype).split(".")[-1] == w.dtype.name, (
            name, g.dtype, w.dtype)
        np.testing.assert_array_equal(_np(g), _bits(w), err_msg=name)


def _ref_seg(x, seg, ks, nsegs, **kw):
    return jsel.segmented_order_statistic(
        jnp.asarray(x), jnp.asarray(seg), jnp.asarray(ks), nsegs=nsegs, **kw)


def _port_seg(x, seg, ks, nsegs, **kw):
    return tsel.segmented_order_statistic(_t(x), _t(seg), _t(ks),
                                          nsegs=nsegs, **kw)


# ---------------------------------------------------------------------------
# segmented_slots and segmented_histogram_ref
# ---------------------------------------------------------------------------


def _ladders(dtype=np.float32):
    """Five ladders of 16 bins: data scale, narrow, full range, one ulp
    (duplicated edges) and a point bracket (all edges equal)."""
    one_up = float(np.nextafter(np.float32(0.25), np.float32(1)))
    lo = np.array([-2.0, 0.25, -3e38, 0.25, 1.0], np.float32)
    hi = np.array([3.0, 0.25 + 1e-5, 2e38, one_up, 1.0], np.float32)
    return tref.bin_edges(_t(lo), _t(hi), 16).numpy().astype(dtype)


def _special_segments(n, nsegs, seed, integer=False):
    rng = np.random.default_rng(seed)
    x = (rng.integers(-3, 4, n).astype(np.float32) if integer
         else rng.standard_normal(n).astype(np.float32))
    if not integer:
        x[:12] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 0.25, 1.0, 3.0, -2.0,
                  3e38, -3e38, 0.25 + 1e-5]
    seg = rng.integers(0, nsegs, n).astype(np.int32)
    return x, seg


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_segmented_slots_equal_reference(dtype):
    x, seg = _special_segments(4099, 5, 1)
    edges = _ladders()
    xt = _t(x)
    xj = jnp.asarray(x)
    if dtype == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = tref.segmented_slots(xt, _t(seg), _t(edges))
    want = np.asarray(_jit_slots(xj, jnp.asarray(seg), jnp.asarray(edges)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the oracle: each element searched in its own segment's ladder
    row = tref.searchsorted_slots(xt.to(torch.float32)[:, None],
                                  _t(edges)[seg.astype(np.int64)])[:, 0]
    np.testing.assert_array_equal(got.numpy(), row.numpy())


def test_segmented_histogram_equals_reference():
    """Counts bit for bit with the specials; per-slot sums bit for bit on
    integer data (exact in any order)."""
    edges = _ladders()
    x, seg = _special_segments(4099, 5, 2)
    got = tref.segmented_histogram_ref(_t(x), _t(seg), _t(edges))
    want = _jit_hist(jnp.asarray(x), jnp.asarray(seg), jnp.asarray(edges))
    assert len(got) == 1 and got[0].dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    xi, segi = _special_segments(4099, 5, 3, integer=True)
    got = tref.segmented_histogram_ref(_t(xi), _t(segi), _t(edges),
                                       rows=(_t(xi),))
    want = _jit_hist_sums(jnp.asarray(xi), jnp.asarray(segi),
                          jnp.asarray(edges))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _bits(w))


def test_group_plan_alone_equals_among_others():
    """A group's sum, min and max are the same bits alone as among groups
    of other sizes (the tree follows the group's size only), and sums are
    within the tree's rounding of the f64 sum."""
    rng = np.random.default_rng(4)
    sizes = [1, 127, 128, 129, 5000, 0, 16385]
    gid = np.repeat(np.arange(len(sizes)), sizes)
    v = rng.standard_normal(gid.size).astype(np.float32)
    plan = tref.GroupPlan(_t(gid), len(sizes))
    vals = _t(np.stack([v, -v], axis=-1))
    sums = plan.reduce(vals)
    start = np.concatenate([[0], np.cumsum(sizes)])
    for g, s in enumerate(sizes):
        part = v[start[g]:start[g] + s]
        if s == 0:
            assert sums[g, 0].item() == 0.0 and not torch.signbit(sums[g, 0])
            continue
        alone = tref.GroupPlan(_t(np.zeros(s, np.int64)), 1)
        a = alone.reduce(_t(np.stack([part, -part], axis=-1)))
        np.testing.assert_array_equal(_np(a[0]), _np(sums[g]))
        for op, want in (("min", part.min()), ("max", part.max())):
            assert alone.reduce(_t(part), op)[0].item() == want
            assert plan.reduce(_t(v), op)[g].item() == want
        assert abs(float(a[0, 0]) - part.astype(np.float64).sum()) <= \
            1e-6 * np.abs(part).sum()


# ---------------------------------------------------------------------------
# segmented_order_statistic against the reference
# ---------------------------------------------------------------------------


def _segment_case(n, interleave, seed=6):
    """Segments of every kind: one element, tiny, constant, with ±inf,
    and a bulk of randn at different scales; the last takes the rest."""
    rng = np.random.default_rng(seed)
    sizes = [1, 7, 3000, 1000, 513]
    sizes.append(n - sum(sizes))
    parts = [rng.standard_normal(s).astype(np.float32)
             * np.float32(10.0 ** float(rng.integers(-3, 3)))
             for s in sizes]
    parts[3][:] = np.float32(1.5)                       # constant
    parts[4][:6] = [np.inf, -np.inf, np.inf, -np.inf, 0.0, -0.0]
    x = np.concatenate(parts)
    seg = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    if interleave:
        p = rng.permutation(n)
        x, seg = x[p], seg[p]
    ks = np.array([1, 4, 1, 500, 3, 2 * sizes[5] // 3], np.int32)
    return x, seg, ks, len(sizes)


@pytest.mark.parametrize("layout", ["interleaved", "contiguous"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_binned_every_field_equals_reference(layout, dtype):
    x, seg, ks, nsegs = _segment_case(N, layout == "interleaved")
    xt, xj = _t(x), jnp.asarray(x)
    if dtype == "bf16":
        xt, xj = xt.to(torch.bfloat16), xj.astype(jnp.bfloat16)
    got = tsel.segmented_order_statistic(xt, _t(seg), _t(ks), nsegs=nsegs)
    want = jsel.segmented_order_statistic(xj, jnp.asarray(seg),
                                          jnp.asarray(ks), nsegs=nsegs)
    assert_fields(got, want)
    xs = xt.to(torch.float32).numpy()
    exp = [np.sort(xs[seg == i])[k - 1] for i, k in enumerate(ks)]
    np.testing.assert_array_equal(got.value.numpy(), np.float32(exp))
    assert cp_objective.LAUNCHES == {k: 0 for k in cp_objective.LAUNCHES}


def test_cp_leg_value_status_n_in_equal_reference():
    """n = 50,000 takes the cp leg.  value, status and n_in equal the
    reference; iters, y_lo and y_hi follow the last bits of each segment's
    sums (a fixed tree here, a sequential sum in the reference), so they
    may differ."""
    x, seg, ks, nsegs = _segment_case(N_CP, True, seed=7)
    got = _port_seg(x, seg, ks, nsegs)
    want = _ref_seg(x, seg, ks, nsegs)
    assert_fields(got, want, ("value", "status", "n_in"))
    exp = [np.sort(x[seg == i])[k - 1] for i, k in enumerate(ks)]
    np.testing.assert_array_equal(got.value.numpy(), np.float32(exp))


def test_sort_leg_equals_reference():
    x, seg, ks, nsegs = _segment_case(N_CP, True, seed=8)
    assert_fields(_port_seg(x, seg, ks, nsegs, method="sort"),
                  _ref_seg(x, seg, ks, nsegs, method="sort"))


def test_segmented_quantiles_ranks_equal_reference():
    """Distinct values, so a value names its rank: the f64 host ranks of
    q = 0, tiny, 0.5, 1 - tiny and 1 over segments of odd sizes."""
    rng = np.random.default_rng(9)
    sizes = [1, 3, 999, 4097, 10_000, 7]
    x = rng.permutation(sum(sizes)).astype(np.float32)
    seg = np.repeat(np.arange(len(sizes), dtype=np.int32), sizes)
    for q in (0.0, 1e-9, 0.5, 0.999999, 1.0,
              [0.1, 0.9, 0.3337, 0.25, 0.999, 0.5]):
        got = tsel.segmented_quantiles(_t(x), _t(seg), q, sizes,
                                       method="sort")
        want = jsel.segmented_quantiles(jnp.asarray(x), jnp.asarray(seg), q,
                                        sizes, method="sort")
        assert_fields(got, want)


# ---------------------------------------------------------------------------
# the port alone: priors, a segment alone against its company
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_prior_changes_no_answer(method):
    """As the reference's test_warm_equals_cold_segmented: a prior (the
    cold result, a shifted one, NaN) changes no value.  It may change how
    a value is certified (an exact prior certifies in its first sweep or
    pass, ``EXACT_HIT``, where the cold solve compacts) and takes no more
    sweeps or passes than the cold solve."""
    x, seg, ks, nsegs = _segment_case(N_CP, True, seed=10)
    cold = _port_seg(x, seg, ks, nsegs, method=method)
    shifted = tsel.Prior(*(f + 0.5 for f in tsel.as_prior(cold)))
    nan = torch.full((nsegs,), float("nan"))
    for prior in (cold, shifted, tsel.Prior(nan, nan, nan, nan)):
        warm = _port_seg(x, seg, ks, nsegs, method=method, prior=prior)
        assert torch.equal(warm.value, cold.value)
    warm = _port_seg(x, seg, ks, nsegs, method=method, prior=cold)
    assert torch.all(warm.iters <= cold.iters)


def _dense_case(seed):
    rng = np.random.default_rng(seed)
    n, nsegs = 40_000, 8
    x = (rng.standard_normal(n) * 3.0 + 0.1).astype(np.float32)
    seg = rng.integers(0, nsegs, n).astype(np.int32)
    sizes = np.bincount(seg, minlength=nsegs)
    ks = (rng.random(nsegs) * sizes).astype(np.int32) + 1
    return x, seg, ks, nsegs


@pytest.mark.parametrize("threads", [2, 6])
@pytest.mark.parametrize("method", ["cp", "binned_polish"])
def test_segment_alone_equals_its_entry_among_eight(method, threads):
    """Dense randn, where every sum rounds: each segment solved alone
    equals its entry among the 8 in every field, and a relabelling of the
    segment ids permutes the results and changes nothing else."""
    x, seg, ks, nsegs = _dense_case(11)
    # the cap follows the whole array's size, so it is held fixed
    kw = dict(method=method, cap=tsel._default_cap_rows(x.size))
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        among = _port_seg(x, seg, ks, nsegs, **kw)
        for i in range(nsegs):
            alone = _port_seg(x[seg == i], np.zeros((seg == i).sum(),
                                                    np.int32),
                              ks[i:i + 1], 1, **kw)
            for name in FIELDS:
                a, b = getattr(alone, name), getattr(among, name)[i:i + 1]
                assert torch.equal(a, b), (i, name, a, b)
        perm = np.random.default_rng(12).permutation(nsegs)
        relabel = _port_seg(x, perm[seg].astype(np.int32),
                            ks[np.argsort(perm)], nsegs, **kw)
        for name in FIELDS:
            assert torch.equal(getattr(relabel, name)[perm],
                               getattr(among, name)), name
    finally:
        torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# eval_* and FnEvaluator
# ---------------------------------------------------------------------------


def test_eval_fg_equals_reference():
    """Integer data: every sum exact, every FG field bit for bit."""
    rng = np.random.default_rng(13)
    x = rng.integers(-50, 50, (3, 999)).astype(np.float32)
    y = np.array([0.5, -3.0, 7.0], np.float32)
    k = np.array([1, 500, 999], np.int32)
    pairs = [(tobj.eval_fg(_t(x[0]), float(y[0]), 500),
              jobj.eval_fg(jnp.asarray(x[0]), y[0], 500)),
             (tobj.eval_fg_batched(_t(x), _t(y), _t(k)),
              jobj.eval_fg_batched(jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(k)))]
    for got, want in pairs:
        for name in tobj.FG._fields:
            np.testing.assert_array_equal(_np(getattr(got, name)),
                                          _bits(getattr(want, name)),
                                          err_msg=name)
    for g, w in zip(tobj.eval_partials(_t(x[1]), 2.0),
                    jobj.eval_partials(jnp.asarray(x[1]), 2.0)):
        np.testing.assert_array_equal(_np(g), _bits(w))


@pytest.mark.parametrize("weighted", [False, True])
def test_fn_evaluator_drives_the_engine_as_its_source(weighted):
    """An FnEvaluator over a RowsEvaluator's closures (weighted: with
    ``weights_total``) gives the loops' states bit for bit; a histogram
    closure without ``need_msum`` drives plain sweeps but not the
    polish."""
    rng = np.random.default_rng(14)
    x = _t(rng.standard_normal((3, 5000)).astype(np.float32))
    w = _t(rng.integers(0, 4, (3, 5000)).astype(np.float32))
    if weighted:
        src = tobj.RowsEvaluator(x, _t(np.array([10.0, 700.0, 3000.0],
                                                np.float32)), weights=w)
        fn = tobj.FnEvaluator(
            lambda y: ops.fused_weighted_partials_batched(x, w, y), src.n,
            src.k, src.init_stats, histogram=src.histogram,
            weights_total=src.W)
    else:
        src = tobj.RowsEvaluator(x, _t(np.array([1, 2500, 5000], np.int32)))
        fn = tobj.FnEvaluator(lambda y: ops.fused_partials_batched(x, y),
                              src.n, src.k, src.init_stats,
                              histogram=src.histogram)
    runs = [lambda ev: tsel.bracket_loop_batched(ev, method="cp", cap=64),
            lambda ev: tsel.binned_loop_batched(ev, nbins=16, cap=64,
                                                polish=True)]
    for run in runs:
        a, b = run(src)[0], run(fn)[0]
        for name in ("yL", "yR", "cleL", "cleR", "t_exact", "iters"):
            torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                       rtol=0, atol=0, equal_nan=True,
                                       msg=name)
    plain = tobj.FnEvaluator(fn._partials, src.n, src.k, src.init_stats,
                             histogram=lambda e: src.histogram(e),
                             weights_total=fn.W)
    a = tsel.binned_loop_batched(src, nbins=16, cap=64)[0]
    b = tsel.binned_loop_batched(plain, nbins=16, cap=64)[0]
    assert torch.equal(a.yL, b.yL) and torch.equal(a.iters, b.iters)
    with pytest.raises(ValueError, match="per-slot sums"):
        tsel.binned_loop_batched(plain, nbins=16, cap=64, polish=True)
