"""K3's and K3w's design (``csrc/hist_multi.cu``), held on the CPU.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here numpy models of them are held against the port's
plain versions (``kernels/ref.py``) and the JAX reference's slot oracle:

* the bucket rule: the block's distinct bracket ends sorted once, an
  element's bucket the number of ends below it (the kernel's branch-free
  search; NaN a bucket of its own), each bucket's ladder mask, and a
  ladder's slot-0 and top counts as integer sums of buckets; an in-bracket
  element's slot guessed from the ladder's ends and decided by the realized
  edges.  Together they give ``searchsorted_slots``'s counts on the five
  bracket kinds, duplicated edges, ±inf, NaN and denormals;
* K3w's f32 order, operation for operation: per-thread end-slot
  accumulators in data order, the warp's in-bracket steps in rounds that
  take a ladder whole (their groups found by bit ballots, modelled against
  key equality), a shuffle tree, the warps in order and the block
  sums.  On a constructed case the earlier rounds ("each lane's lowest
  ladder") give a ladder other bits among an overlapping ladder than
  alone, and the new rounds the same; on overlapping ladder sets a ladder
  alone, among 16 and permuted gets the same bits; integer data equal the
  plain version, dense weights stay within the f32 chain of the f64 sums;
* the wrappers' layout rules: the shared bytes of the kernel's layout, the
  warps of a K3w block from the width and the leg alone (never K), and
  a first sweep of identical ladders binning the one ladder.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.kernels import cp_objective as cpo  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


F32 = np.float32
ONE_UP = float(np.nextafter(F32(0.25), F32(1)))
KINDS = [(-3e38, 3e38), (-2.0, 2.0), (-1e-3, 2e-3), (0.25, ONE_UP),
         (-1e-40, 1e-40)]


def _edges(brackets, nbins=128):
    lo = torch.tensor([b[0] for b in brackets], dtype=torch.float32)
    hi = torch.tensor([b[1] for b in brackets], dtype=torch.float32)
    return tref.bin_edges(lo, hi, nbins).numpy()


def _special(rng, n):
    """randn with ±0, ±inf, NaN, denormals and ±3e38 planted."""
    x = rng.standard_normal(n).astype(F32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-44,
                        1e-39, -3e-39, 3e38, -3e38, 0.25, ONE_UP], F32)
    x[rng.choice(n, special.size * 4, replace=False)] = np.tile(special, 4)
    return x


def _ladder_sets(x):
    """16 ladders each: identical first-sweep ones, the five bracket kinds
    cycled (nested and disjoint), staggered (each overlapping its
    neighbours in part), polished first-sweep ones (each over [min, max],
    half its edges around its own cut: every element inside all), and
    duplicated edges (a one-ulp bracket, and a zero-width one)."""
    fin = x[np.isfinite(x)]
    lo, hi = float(fin.min()), float(fin.max())
    cuts = np.linspace(-1.5, 1.5, 16).astype(F32)
    polished = tsel.polish_edges(torch.full((16,), lo), torch.full((16,), hi),
                                 torch.from_numpy(cuts), 128).numpy()
    dup = _edges([(0.25, ONE_UP), (0.5, 0.5)] * 8)
    return {"identical": _edges([(lo, hi)] * 16),
            "cycled": _edges([KINDS[j % 5] for j in range(16)]),
            "staggered": _edges([(-2 + 0.25 * j, -1 + 0.25 * j)
                                 for j in range(16)]),
            "polished": polished, "duplicated": dup}


# ---------------------------------------------------------------------------
# the bucket and slot rules (K3 and K3w)
# ---------------------------------------------------------------------------


def sorted_ends(edges):
    """The block's distinct bracket ends, ascending (NaN ends left out),
    and each ladder's ranks of its lower and upper end (-1 for NaN)."""
    ends = []
    for e in edges:
        for v in (e[0], e[-1]):
            if not np.isnan(v) and not any(v == u for u in ends):
                ends.append(F32(v))
    ends = np.sort(np.array(ends, F32))
    ranks = [[next((k for k, u in enumerate(ends) if u == v), -1)
              for v in (e[0], e[-1])] for e in edges]
    return ends, np.array(ranks, np.int64).reshape(-1, 2)


def bucket(v, ends, groups):
    """The kernel's branch-free search: ``ends`` padded with +inf to the
    block's 2G entries, ``pow2`` the least power of two >= their number;
    NaN takes bucket 2G + 1."""
    pad = np.full(2 * groups, np.inf, F32)
    pad[:ends.size] = ends
    pow2 = 1
    while pow2 < ends.size:
        pow2 *= 2
    q = np.zeros(v.shape, np.int64)
    step = pow2 // 2
    while step > 0:
        q = np.where(pad[q + step - 1] < v, q + step, q)
        step //= 2
    q = q + (pad[q] < v)
    return np.where(np.isnan(v), 2 * groups + 1, q)


def bucket_masks(ranks, groups):
    """Per bucket, the ladders whose bracket holds its elements:
    rank(lo) < q <= rank(hi)."""
    masks = np.zeros(2 * groups + 2, np.int64)
    for j, (rlo, rhi) in enumerate(ranks):
        for q in range(rlo + 1, rhi + 1):
            masks[q] |= 1 << j
    return masks


def guess_slot(v, e):
    """The kernel's slot of an in-bracket v: the guess from the ladder's
    ends in f32, taken if the realized edges agree, else the search."""
    nb = e.size - 1
    with np.errstate(all="ignore"):
        h0 = F32(0.5) * e[0]
        sc = F32(nb) / (F32(0.5) * e[-1] - h0)
        g = np.ceil((F32(0.5) * v - h0) * sc)
    g = int(min(max(g, 1), nb)) if np.isfinite(g) else 1
    if e[g - 1] < v <= e[g]:
        return g
    return int(np.searchsorted(e, v, side="left"))


def bucket_counts(x, edges, groups=16):
    """K3's counts of ``x`` against ``edges`` (K <= groups ladders): end
    slots from the buckets' integer sums, in-bracket slots from the guess
    rule, one slot search per ladder an element's bucket names."""
    k, ne = edges.shape
    ends, ranks = sorted_ends(edges)
    q = bucket(x, ends, groups)
    masks = bucket_masks(ranks, groups)
    btot = np.bincount(q, minlength=2 * groups + 2)
    cnt = np.zeros((k, ne + 1), np.int64)
    for j, (rlo, rhi) in enumerate(ranks):
        top = max(rlo, rhi)
        cnt[j, 0] = btot[:rlo + 1].sum()
        cnt[j, -1] = btot[top + 1:].sum()
    for v, m in zip(x, masks[q]):
        for j in range(k):
            if (m >> j) & 1:
                cnt[j, guess_slot(v, edges[j])] += 1
    return cnt


@pytest.mark.parametrize("label", ["identical", "cycled", "staggered",
                                   "polished", "duplicated"])
def test_bucket_rule_gives_the_slot_oracle_counts(label):
    x = _special(np.random.default_rng(1), 3000)
    edges = _ladder_sets(x)[label]
    got = bucket_counts(x, edges)
    want = tref.cp_histogram_multi_ref(torch.from_numpy(x),
                                       torch.from_numpy(edges),
                                       want_sums=False)[0].numpy()
    np.testing.assert_array_equal(got, want)
    # the reference's oracle where it does not flush denormals to zero:
    # on the other values, against the ladders without denormal edges
    def denormal(a):
        return (a != 0) & (np.abs(a) < np.finfo(F32).tiny)

    keep = ~denormal(x)
    ok = [j for j, e in enumerate(edges) if not denormal(e).any()]
    oracle = np.stack([np.bincount(np.asarray(jref.searchsorted_slots(
        jnp.asarray(x[keep]), jnp.asarray(edges[j]))),
        minlength=edges.shape[1] + 1) for j in ok])
    np.testing.assert_array_equal(bucket_counts(x[keep], edges)[ok], oracle)


def test_bucket_search_counts_the_ends_below():
    """The padded branch-free search is ``searchsorted(ends, v, 'left')``
    at every number of ends a block of 1 to 16 ladders can have, on the
    ends themselves, their neighbours, ±inf and NaN."""
    rng = np.random.default_rng(2)
    for groups in (1, 2, 4, 8, 16):
        for d in range(0, 2 * groups + 1):
            ends = np.unique(rng.standard_normal(d).astype(F32))
            probe = np.concatenate([
                ends, np.nextafter(ends, F32(-np.inf)),
                np.nextafter(ends, F32(np.inf)),
                np.array([-np.inf, np.inf, np.nan, 0.0, -0.0], F32)])
            got = bucket(probe, ends, groups)
            want = np.where(np.isnan(probe), 2 * groups + 1,
                            np.searchsorted(ends, probe, side="left"))
            np.testing.assert_array_equal(got, want)


def test_guess_rule_is_the_search_on_every_bracket_kind():
    x = _special(np.random.default_rng(3), 4000)
    for lo, hi in KINDS + [(-1.0, 1.0), (0.5, 0.5)]:
        e = _edges([(lo, hi)])[0]
        inside = x[(x > e[0]) & (x <= e[-1])]
        for v in inside:
            assert guess_slot(v, e) == int(np.searchsorted(e, v, "left"))


# ---------------------------------------------------------------------------
# K3w's order of f32 additions
# ---------------------------------------------------------------------------


def tree(v):
    """``warp_sum``: a shuffle-down tree over the last axis (32 lanes);
    lane 0's value."""
    v = np.array(v, F32)
    o = 16
    while o > 0:
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
        o //= 2
    return v[..., 0]


def in_step(rows, v, p, inside, edges, rounds):
    """One warp step of in-bracket adds into ``rows`` (K, nslots) f32:
    lane l brings v[l], its weight p[l] and the mask of ladders holding it.
    ``rounds`` "whole" (this design): a ladder is taken when no lane holds
    it back; "lowest" (the earlier one): each lane takes its lowest
    ladder.  A group (ladder, slot) sums its weights in lane order from 0
    and adds the sum to its row entry."""
    rem = inside.copy()
    while rem.any():
        mine = rem & -rem
        held = np.bitwise_or.reduce(rem & ~mine)
        go = (mine != 0) if rounds == "lowest" else (mine & ~held) != 0
        groups = {}
        for lane in np.flatnonzero(go):
            j = int(mine[lane]).bit_length() - 1
            key = (j, guess_slot(v[lane], edges[j]))
            groups.setdefault(key, []).append(lane)
        for (j, s), lanes in groups.items():
            acc = F32(0)
            for lane in lanes:
                acc = F32(acc + p[lane])
            rows[j, s] = F32(rows[j, s] + acc)
        rem = np.where(go, rem & ~mine, rem)


def k3w_model(x, w, edges, rounds="whole", warps=None, nblk=None):
    """K3w's counts and f32 masses, ladder by ladder as the wrapper returns
    them (K, nslots), f32 operation for f32 operation: element
    b*T + t + k*stride is thread t of block b's k-th (T = 32 * warps,
    stride = nblk * T); a ladder equal to an earlier one copies its
    outputs.  ``warps`` defaults to the wrapper's."""
    x, w = np.asarray(x, F32), np.asarray(w, F32)
    edges = np.asarray(edges, F32)
    k, ne = edges.shape
    n = x.size
    warps = warps or cpo.hist_multi_layout(k, ne, 1)[1]
    nblk = nblk or cpo.fg_blocks(n)
    T, stride = 32 * warps, nblk * 32 * warps
    rep = [next(p for p in range(j + 1) if np.array_equal(
        edges[p], edges[j], equal_nan=True)) for j in range(k)]
    binned = [j for j in range(k) if rep[j] == j]
    lo, hi = edges[:, 0], edges[:, -1]
    part = np.zeros((nblk, k, ne + 1), F32)
    for b in range(nblk):
        rows = np.zeros((warps, k, ne + 1), F32)
        for wp in range(warps):
            first = b * T + wp * 32 + np.arange(32)
            pb = np.zeros((32, k), F32)
            pa = np.zeros((32, k), F32)
            for step in range(-(-(n - first[0]) // stride)):
                idx = first + step * stride
                ok = idx < n
                v = np.where(ok, x[np.minimum(idx, n - 1)], F32(np.nan))
                p = np.where(ok, w[np.minimum(idx, n - 1)], F32(0))
                inside = np.zeros(32, np.int64)
                for j in binned:
                    le_lo, le_hi = v <= lo[j], v <= hi[j]
                    pb[:, j] = np.where(le_lo, pb[:, j] + p, pb[:, j])
                    pa[:, j] = np.where(le_hi, pa[:, j], pa[:, j] + p)
                    inside |= (~le_lo & le_hi).astype(np.int64) << j
                in_step(rows[wp], v, p, inside, edges, rounds)
            for j in binned:
                rows[wp, j, 0] = tree(pb[:, j])
                rows[wp, j, -1] = tree(pa[:, j])
        for j in range(k):
            acc = np.zeros(ne + 1, F32)
            for wp in range(warps):
                acc = acc + rows[wp, rep[j]]
            part[b, j] = acc
    # sum_blocks: lane l adds blocks l, l + 32, ... in order, then a tree
    lanes = np.zeros((32, k, ne + 1), F32)
    for blk in range(nblk):
        lanes[blk % 32] = lanes[blk % 32] + part[blk]
    mass = tree(np.moveaxis(lanes, 0, -1))
    cnt = tref.cp_histogram_multi_ref(torch.from_numpy(x),
                                      torch.from_numpy(edges),
                                      want_sums=False)[0].numpy()
    return cnt, mass


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def same_keys(keys):
    """The kernel's grouping of one warp step: the active lanes' keys
    (>= 0) OR-ed and AND-ed over the warp tell which bits differ; one
    ballot per such bit narrows each lane's group to the lanes that agree
    with it there."""
    keys = np.asarray(keys, np.int64)
    has = keys >= 0
    k = np.where(has, keys, 0xFFFFFFFF).astype(np.uint32)
    lanes = np.uint32(1) << np.arange(32, dtype=np.uint32)
    active = np.bitwise_or.reduce(np.where(has, lanes, np.uint32(0)))
    ors = np.bitwise_or.reduce(np.where(has, k, np.uint32(0)))
    ands = np.bitwise_and.reduce(np.where(has, k, np.uint32(0xFFFFFFFF)))
    grp = np.full(32, active, np.uint32)
    vary = int(ors & ~ands)
    while vary:
        bit = np.uint32(vary & -vary)
        one = (k & bit) != 0
        ballot = np.bitwise_or.reduce(np.where(one, lanes, np.uint32(0)))
        grp = np.where(one, grp & ballot, grp & ~ballot)
        vary &= vary - 1
    return grp


def test_ballot_grouping_is_key_equality():
    """``same_keys`` gives each active lane exactly the lanes with its key
    (what __match_any_sync gives), on random steps with absent lanes, one
    key, all keys distinct, and keys of several ladders."""
    rng = np.random.default_rng(6)
    cases = [rng.integers(-1, 130, 32), np.full(32, 7), np.arange(32) * 3,
             rng.integers(0, 4, 32) * 130 + rng.integers(1, 129, 32),
             np.where(rng.random(32) < 0.5, -1, rng.integers(0, 5, 32)),
             np.full(32, -1)]
    for keys in cases:
        got = same_keys(keys)
        for lane in np.flatnonzero(np.asarray(keys) >= 0):
            want = sum(1 << m for m in range(32) if keys[m] == keys[lane])
            assert int(got[lane]) == want


def test_lowest_ladder_rounds_follow_the_company():
    """Lane 0 inside ladders A and B, lane 1 inside B only, both in B's
    slot s, whose row already holds 1.0 (an earlier step); weights 2^-24.
    The earlier rounds add them to B's row in two rounds, (1 + 2^-24) +
    2^-24 = 1, where B alone adds them as one group, 1 + 2^-23; the new
    rounds take B whole in both."""
    n = 512  # one block of 8 warps: warp 0's steps hold 0..31, 256..287
    x = np.full(n, -100.0, F32)
    w = np.full(n, 0.5, F32)
    x[0], w[0] = 3.05, 1.0          # step 0: B's slot s gets 1.0
    x[256], w[256] = 3.0, 2.0 ** -24  # step 1, lane 0: in A and B
    x[257], w[257] = 3.1, 2.0 ** -24  # step 1, lane 1: in B only
    edges = _edges([(-5.0, 3.0), (0.0, 20.0)])
    s = int(np.searchsorted(edges[1], F32(3.0), "left"))
    assert s == int(np.searchsorted(edges[1], F32(3.1), "left"))
    assert s == int(np.searchsorted(edges[1], F32(3.05), "left"))
    old_among = k3w_model(x, w, edges, "lowest")[1][1]
    old_alone = k3w_model(x, w, edges[1:], "lowest")[1][0]
    assert old_among[s] == F32(1.0) and old_alone[s] == F32(1 + 2 ** -23)
    new_among = k3w_model(x, w, edges, "whole")[1][1]
    new_alone = k3w_model(x, w, edges[1:], "whole")[1][0]
    np.testing.assert_array_equal(_bits(new_among), _bits(new_alone))
    assert new_alone[s] == F32(1 + 2 ** -23)


@pytest.mark.parametrize("label", ["identical", "cycled", "staggered",
                                   "polished"])
def test_ladder_alone_equals_among_16(label):
    """Dense weights at 2 blocks of 8 warps: each ladder alone, the 16,
    and the 16 permuted give every ladder the same bits."""
    rng = np.random.default_rng(4)
    n = 1 << 14
    x = _special(rng, n)
    w = (rng.random(n) + 0.5).astype(F32)
    edges = _ladder_sets(x)[label]
    cnt, mass = k3w_model(x, w, edges)
    perm = rng.permutation(16)
    cp, mp = k3w_model(x, w, edges[perm])
    np.testing.assert_array_equal(cp, cnt[perm])
    np.testing.assert_array_equal(_bits(mp), _bits(mass[perm]))
    for j in (0, 7, 15):
        c1, m1 = k3w_model(x, w, edges[j:j + 1])
        np.testing.assert_array_equal(c1[0], cnt[j])
        np.testing.assert_array_equal(_bits(m1[0]), _bits(mass[j]))


@pytest.mark.parametrize("label", ["cycled", "staggered", "duplicated"])
def test_model_equals_plain_on_integers_and_f64_on_dense(label):
    """Integer weights (totals below 2^24): the plain version's masses bit
    for bit; dense weights: within the f32 chain of the f64 masses."""
    rng = np.random.default_rng(5)
    n = 3000
    x = _special(rng, n)
    edges = _ladder_sets(x)[label]
    wi = rng.integers(0, 8, n).astype(F32)
    want = tref.wcp_histogram_multi_ref(torch.from_numpy(x),
                                        torch.from_numpy(wi),
                                        torch.from_numpy(edges),
                                        want_sums=False)
    cnt, mass = k3w_model(x, wi, edges)
    np.testing.assert_array_equal(cnt, want[0].numpy())
    np.testing.assert_array_equal(mass, want[1].numpy())
    wd = (rng.random(n) + 0.5).astype(F32)
    exact = tref.wcp_histogram_multi_ref(
        torch.from_numpy(x), torch.from_numpy(wd.astype(np.float64)),
        torch.from_numpy(edges), want_sums=False)[1].numpy()
    _, mass = k3w_model(x, wd, edges)
    chain = 32 + 5 + 8 + 32 + 5  # steps, a group, tree, warps, blocks
    assert np.all(np.abs(mass - exact) <= chain * 2.0 ** -24 * exact)


# ---------------------------------------------------------------------------
# the wrappers' layout rules
# ---------------------------------------------------------------------------


def layout_words(group, nedges, warps, nrows):
    """The kernel's ``Layout``: edges and counts per ladder, 2G sorted
    ends, per bucket (2G + 2) three masks and a total, per ladder a guess
    origin, scale and two end ranks, per warp (G + 1) x 32 counter words,
    nrows f32 rows per ladder and slot, and a stage of 32 x nrows."""
    nslots = nedges + 1
    return (group * nedges + group * nslots + 2 * group
            + 4 * (2 * group + 2) + 4 * group + warps * (group + 1) * 32
            + warps * group * nslots * nrows + warps * 32 * nrows * 4)


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("nedges", [2, 129, 8193])
@pytest.mark.parametrize("nrows", [0, 1, 2])
def test_smem_is_the_kernel_layout(group, nedges, nrows):
    for warps in (1, 4, 8):
        assert cpo.hist_multi_smem(group, warps, nedges, nrows) == \
            4 * layout_words(group, nedges, warps, nrows)


@pytest.mark.parametrize("nedges", [2, 129, 1025, 8193, 9651, 12289])
@pytest.mark.parametrize("nrows", [1, 2])
def test_warps_do_not_follow_k(nedges, nrows):
    """A ladder's order of additions follows the block's warps, so they
    come from the width and the leg alone; the group fits the block."""
    plans = [cpo.hist_multi_layout(k, nedges, nrows) for k in (1, 3, 16, 64)]
    assert len({warps for _, warps in plans}) == 1
    for group, warps in plans:
        assert cpo.hist_multi_smem(group, warps, nedges, nrows) <= \
            cpo.HIST_OPTIN_SMEM
    assert [g for g, _ in plans][0] == 1
    assert cpo.whist_multi_plan(16, nedges, nrows, False)[2] == (
        plans[0][1],)


def test_layout_raises_where_one_ladder_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cpo.hist_multi_layout(1, 1 << 16, 2)


def test_k3_group_fits_without_opting_in():
    for nedges in (2, 129, 257, 1025):
        g = cpo.hist_multi_group(16, nedges)
        assert cpo.hist_multi_smem(g, cpo.LANE_WARPS, nedges, 0) <= \
            cpo.HIST_MAX_SMEM or g == 1


def test_first_sweep_of_identical_ladders_bins_one():
    """A first sweep (``full_bracket``) of one ladder, or of identical
    ladders, bins the one ladder (K3: K1's lane kernel; K3w: the ladder
    alone, whose bits its company does not change); distinct ladders and
    other sweeps bin all of them."""
    one = torch.from_numpy(_edges([(-1.0, 1.0)] * 16))
    two = torch.from_numpy(_edges([(-1.0, 1.0)] * 15 + [(-1.0, 2.0)]))
    assert cpo.one_ladder(one, True) and cpo.one_ladder(one[:1], True)
    assert not cpo.one_ladder(one, False)
    assert not cpo.one_ladder(two, True)
