"""K4's and K4w's per-(element, pivot) arithmetic, written out on the CPU.

The kernel ``csrc/fg_multi.cu`` forms every term of the partials as one
predicated add behind compares that each give a predicate and its
complement (``setp.gtu p|q`` and friends):

* counting leg: ``d > 0 or NaN`` adds ``d`` to the positive sum (NaN
  propagates, as ``max(d, 0)`` does), its complement ``d <= 0`` counts in
  ``n_le``, ``d < 0 or NaN`` subtracts ``d`` from the negative sum, and
  ``d < 0`` counts in ``n_lt``; where every pivot of a block is finite the
  kernel counts ``d < 0 or NaN`` with an increment that is 0 for a NaN x;
* weighted leg: one product ``p = w*d``; ``d > 0`` adds ``p``, ``d < 0``
  subtracts it (``-(w*d)`` for ``(-w)*d``) and adds ``w`` to the mass
  below, ``d <= 0`` adds ``w`` to the mass at or below; with finite pivots
  the complement of ``d > 0`` (``d <= 0 or NaN``) stands for ``d <= 0``,
  with the weight and count increment of a NaN x zeroed.

A skipped add stands for adding +0.  Here those rules, in torch, meet
K2's select chains (``accumulate`` in ``fg_batched.cu``, which K4 ran too)
and the reference's tile math ``_fg_tile`` term for term on a grid of
specials (±0, ±denormals, ±1e38, ±3e38, ±inf, NaN and bf16-representable
values in x, w and y); a skipped add and an added +0 leave every running
sum with the same bits; and the plain versions' partials do not depend on
the order or the company of the pivots, against the reference's Pallas
bodies in interpret mode.

NaN terms are compared as NaN (a NaN's sign and payload are not part of
the contract).  The jitted reference flushes the inputs and results of
its arithmetic to zero when denormal (ROADMAP Queue 3), so it meets the
rules with the same flush.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import cp_objective as jcp  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

SUM_RTOL = 1e-4
TINY = np.finfo(np.float32).tiny
GRID = np.array([0.0, -0.0, 1e-44, -1e-44, 1e-39, -3e-39, 1.0, -1.0, 0.5,
                 -2.0, 1.5, 1e38, -1e38, 3e38, -3e38, np.inf, -np.inf,
                 np.nan], np.float32)
BF16 = np.array([1.5, -2.0, 0.75, 3.0e38, -1e-39], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs its files in parallel processes: one intra-op thread
    per process (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grid():
    """Every (x, w, y) of GRID, plus the bf16 values rounded through bf16."""
    bf = torch.from_numpy(BF16).to(torch.bfloat16).float().numpy()
    vals = np.concatenate([GRID, bf])
    x, w, y = (np.array(v, np.float32)
               for v in zip(*itertools.product(vals, repeat=3)))
    return torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(y)


def _zero(t):
    return torch.zeros_like(t)


def select_terms(x, w, y):
    """K2's select chains (``accumulate`` in ``fg_batched.cu``):
    counting ``(pos, neg, lt, le)``, weighted ``(pos, neg, wlt, wle, lt,
    le)``, counts as 0/1 floats."""
    d = x - y
    nan = torch.isnan(d)
    zero = _zero(d)
    lt, le = (d < 0).float(), (d <= 0).float()
    counting = (torch.where(d > 0, d, torch.where(nan, d, zero)),
                torch.where(d < 0, -d, torch.where(nan, d, zero)), lt, le)
    weighted = (torch.where(d > 0, w * d, zero),
                torch.where(d < 0, (-w) * d, zero),
                torch.where(d < 0, w, zero), torch.where(d <= 0, w, zero),
                lt, le)
    return counting, weighted


def predicated_terms(x, w, y, finite: bool, flush=lambda t: t):
    """K4's predicated adds, a skipped add as +0;
    ``flush`` applies to the inputs and results of the arithmetic (the
    subtract and the product), as XLA:CPU does."""
    d = flush(flush(x) - flush(y))
    zero, one = _zero(d), torch.ones_like(d)
    gtu = ~(d <= 0)           # setp.gtu: d > 0 or NaN ...
    le = ~gtu                 # ... and its complement, d <= 0
    ltu = ~(d >= 0)           # setp.ltu: d < 0 or NaN
    xnan = torch.isnan(x)
    if finite:                # NaN d is NaN x: its count increment is 0
        lt_count = torch.where(ltu, torch.where(xnan, zero, one), zero)
    else:
        lt_count = (d < 0).float()
    counting = (torch.where(gtu, d, zero), torch.where(ltu, -d, zero),
                lt_count, le.float())
    p = flush(flush(w) * d)
    gt = d > 0
    lt = d < 0
    if finite:                # the complement of d > 0: d <= 0 or NaN
        ngt = ~gt
        wq = torch.where(xnan, zero, w)
        wle = torch.where(ngt, wq, zero)
        le_count = torch.where(ngt, torch.where(xnan, zero, one), zero)
    else:
        wle = torch.where(d <= 0, w, zero)
        le_count = (d <= 0).float()
    weighted = (torch.where(gt, p, zero), torch.where(lt, -p, zero),
                torch.where(lt, w, zero), wle, lt.float(), le_count)
    return counting, weighted


def _same(a, b, where=None):
    """Bit for bit, NaN as NaN (over ``where`` if given)."""
    a, b = a.clone(), b.clone()
    if where is not None:
        a, b = a[where], b[where]
    nan = torch.isnan(a)
    assert torch.equal(nan, torch.isnan(b))
    a[nan] = 0
    b[nan] = 0
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("finite", [False, True], ids=["general", "finite"])
def test_predicated_terms_equal_the_select_chains(finite):
    x, w, y = _grid()
    only = torch.isfinite(y) if finite else None
    for sel, pred in zip(select_terms(x, w, y),
                         predicated_terms(x, w, y, finite)):
        for a, b in zip(sel, pred):
            _same(a, b, only)


def _ftz(t):
    """Denormals to zero of their sign, as XLA:CPU flushes them."""
    return torch.where(t.abs() < TINY, torch.copysign(_zero(t), t), t)


def test_predicated_terms_equal_the_reference_tile_math():
    """``_fg_tile`` on one-element tiles gives the rules' terms bit for bit
    on both legs, with the subtract's and the product's inputs and results
    flushed as XLA:CPU flushes them (selected weights pass unflushed).
    One deliberate difference: where d is NaN the Pallas body adds 0 to
    the counting leg's sums, the rules (as the reference's plain version
    ``cp_partials_ref``, K2 and the port) add NaN."""
    x, w, y = _grid()

    def terms(xi, wi, yi):
        valid = jnp.ones((1, 1), bool)
        counting = jcp._fg_tile(xi.reshape(1, 1), valid, yi)
        weighted = jcp._fg_tile(xi.reshape(1, 1), valid, yi,
                                wi.reshape(1, 1))
        return counting[0] + counting[1] + weighted[0] + weighted[1]

    want = [torch.from_numpy(np.array(v)).float() for v in
            jax.jit(jax.vmap(terms))(x.numpy(), w.numpy(), y.numpy())]
    counting, weighted = predicated_terms(x, w, y, finite=False,
                                          flush=_ftz)
    dnan = torch.isnan(_ftz(_ftz(x) - _ftz(y)))
    for g, v in zip(counting[:2], want[:2]):
        _same(g, v, ~dnan)
        assert torch.isnan(g[dnan]).all() and (v[dnan] == 0).all()
    for g, v in zip([*counting[2:], *weighted], want[2:]):
        _same(g, v)


def test_skipped_add_equals_adding_zero():
    """Running f32 sums from +0 over the grid's terms (shuffled, in
    segments of 31, each summed in sequence as a thread does): skipping
    every term whose predicate is off, where the select gave +0, leaves
    every running sum with the bits of adding it; no such sum is -0."""
    x, w, y = _grid()
    sel, _ = select_terms(x, w, y)
    _, pred_w = predicated_terms(x, w, y, finite=False)
    d = x - y
    masks = [~(d <= 0), ~(d >= 0), d > 0, d < 0, d < 0, d <= 0]
    order = np.random.default_rng(3).permutation(d.numel())
    for terms, mask in zip([*sel[:2], *pred_w[:4]], masks):
        t, m = terms.numpy()[order], mask.numpy()[order]
        added, skipped = [], []
        with np.errstate(over="ignore", invalid="ignore"):  # inf, NaN sums
            for lo in range(0, t.size, 31):
                a = s = np.float32(0)
                for ti, mi in zip(t[lo:lo + 31], m[lo:lo + 31]):
                    a = np.float32(a + ti)
                    s = np.float32(s + ti) if mi else s
                    added.append(a)
                    skipped.append(s)
        added = torch.from_numpy(np.array(added, np.float32))
        _same(added, torch.from_numpy(np.array(skipped, np.float32)))
        assert not ((added == 0) & torch.signbit(added)).any()


def _data(seed, n=1500):
    """Normal data with ±inf planted (no NaN and no denormals: the Pallas
    histogram test data convention; the jitted bodies flush denormals)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    x[:4] = [np.inf, -np.inf, 2.0, -2.0]
    w = rng.integers(0, 4, n).astype(np.float32)
    y = np.array([0.1, float(x[7]), -1.0, 2.0, 0.0, -0.5, float(x[99]),
                  1e30, -3e38], np.float32)
    return rng, x, w, y


def _equal(got, want, index, exact_sums):
    for i, (g, v) in enumerate(zip(got, want)):
        v = np.asarray(v)[index]
        if i < 2 and not exact_sums:
            np.testing.assert_allclose(g.numpy(), v, rtol=SUM_RTOL)
        else:
            np.testing.assert_array_equal(g.numpy(), v)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["counting", "weighted"])
def test_plain_partials_ignore_pivot_order_and_company(weighted):
    """The plain versions of K4/K4w on permuted pivots and on subsets of
    them give each pivot's partials bit for bit, and agree with the
    reference's Pallas body in interpret mode (counts and, with integer
    weights, masses exactly; objective sums within SUM_RTOL)."""
    rng, x, w, y = _data(15)
    xt, wt, yt = (torch.from_numpy(a) for a in (x, w, y))
    if weighted:
        want = jcp.wcp_partials_multi(jnp.asarray(x), jnp.asarray(w),
                                      jnp.asarray(y), block_rows=8,
                                      interpret=True)

        def plain(yy):
            return tref.wcp_partials_multi_ref(xt, wt, yy)
    else:
        want = jcp.cp_partials_multi(jnp.asarray(x), jnp.asarray(y),
                                     block_rows=8, interpret=True)

        def plain(yy):
            return tref.cp_partials_multi_ref(xt, yy)
    full = plain(yt)
    _equal(full, want, slice(None), exact_sums=False)
    picks = [rng.permutation(y.size), rng.permutation(y.size),
             np.array([4]), np.array([8, 1]), np.array([6, 2, 5, 0])]
    for idx in picks:
        got = plain(yt[torch.from_numpy(idx)])
        for g, f in zip(got, full):
            _same(g.float(), f[torch.from_numpy(idx)].float())
        _equal(got, want, idx, exact_sums=False)
