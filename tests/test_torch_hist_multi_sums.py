"""K3s/K3ws's sorted-tile design, held on the CPU.

The sums legs of the multi-ladder histogram (``csrc/hist_multi_sums.cu``)
sort each chunk of the array once by an order-preserving key, then for each
ladder find the slots from the edge keys and sum each slot over its sorted
positions in an order set by those positions alone.  The CUDA kernel runs
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); here a
numpy model of it, f32 operation for f32 operation, is held against the
port's plain versions (``kernels/ref.py``) and the JAX reference's slot
oracle: the key map gives the slots of ``searchsorted_slots`` on data with
±0, ±inf, NaN of either sign and denormals, for uniform, polish and
8192-bin ladders; the sums equal the plain versions bit for bit on integer
data and stay within the chain bound of the f64 sums on randn; a ladder's
block partials are the same bits alone, among 16 and in another order.
The wrapper's layout rules (tile, shared bytes, which design serves which
shape) are checked against the kernel's layout arithmetic.
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
U32 = np.uint32
THREADS = cpo.SORTED_THREADS
ITEMS = cpo.SORTED_ITEMS
TILE = cpo.SORTED_TILE
WARPS = THREADS // 32
NAN_KEY, PAD_KEY = U32(0xFFFFFFFE), U32(0xFFFFFFFF)
NONE = -1
ONE_UP = float(np.nextafter(F32(0.25), F32(1)))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def order_key(x):
    """The kernel's key of f32 values: the order-preserving map of the
    bits, NaN of either sign to 0xFFFFFFFE."""
    x = np.asarray(x, F32)
    b = x.view(U32)
    k = np.where(b & U32(0x80000000), ~b, b | U32(0x80000000)).astype(U32)
    return np.where(np.isnan(x), NAN_KEY, k).astype(U32)


def edge_key(e):
    """The key of an edge: the largest key whose values are <= it (±0: the
    key of +0)."""
    e = np.asarray(e, F32)
    return np.where(e == 0, U32(0x80000000), order_key(e)).astype(U32)


def key_value(k):
    k = np.asarray(k, U32)
    b = np.where(k & U32(0x80000000), k & U32(0x7FFFFFFF), ~k).astype(U32)
    return b.view(F32)


def padded_edge_keys(edges):
    """A ladder's edge keys, then the NaN key, then padding keys up to a
    power of two above ``nedges`` (the kernel's ``ekey`` row)."""
    ne = edges.shape[-1]
    pad = 1 << ne.bit_length()
    out = np.full(pad, PAD_KEY, U32)
    out[:ne] = edge_key(edges)
    out[ne] = NAN_KEY
    return out


def key_slots(x, edges):
    """The model's slot of each value: the number of padded edge keys below
    its key (the kernel's ``count_lt``)."""
    ek = padded_edge_keys(np.asarray(edges, F32))
    return np.searchsorted(ek, order_key(x), side="left")


def seq_sum(vals, axis=-1):
    """Sum along ``axis`` in order, from +0, in f32."""
    vals = np.moveaxis(np.asarray(vals, F32), axis, -1)
    acc = np.zeros(vals.shape[:-1], F32)
    for i in range(vals.shape[-1]):
        acc = acc + vals[..., i]
    return acc


def sort_chunk(keys, w):
    """The sorted tile of one chunk: thread t loads chunk positions
    t + THREADS u as its items t ITEMS + u; the sort is stable in that
    order; padding past the chunk's elements takes the largest key."""
    valid = keys.size
    pk = np.full(TILE, PAD_KEY, U32)
    pw = np.zeros(TILE, F32)
    pk[:valid] = keys
    pw[:valid] = w
    rank = np.arange(TILE)
    pos = (rank % ITEMS) * THREADS + rank // ITEMS  # position of each item
    order = np.argsort(pk[pos], kind="stable")
    return pk[pos][order], pw[pos][order]


def ks_up(v):
    """A warp's inclusive Kogge-Stone scan over lanes (axis -1, 32), each
    step ``left + right``."""
    v = v.copy()
    o = 1
    while o < 32:
        v[..., o:] = v[..., :-o].copy() + v[..., o:]
        o *= 2
    return v


def ks_down(v):
    """The suffix twin of :func:`ks_up` (each step ``own + next``)."""
    v = v.copy()
    o = 1
    while o < 32:
        v[..., :-o] = v[..., :-o] + v[..., o:].copy()
        o *= 2
    return v


def strip_scans(g):
    """Per strip (rows, 256), the sums of the strips before (pre) and after
    (suf) it: a warp's scans, then the warps in order."""
    rows = g.shape[0]
    gw = g.reshape(rows, WARPS, 32)
    inc, sinc = ks_up(gw), ks_down(gw)
    pre_l = np.concatenate([np.zeros((rows, WARPS, 1), F32), inc[..., :-1]],
                           axis=-1)
    suf_l = np.concatenate([sinc[..., 1:], np.zeros((rows, WARPS, 1), F32)],
                           axis=-1)
    off = np.zeros((rows, WARPS), F32)
    soff = np.zeros((rows, WARPS), F32)
    for w in range(WARPS):
        acc = np.zeros(rows, F32)
        for q in range(w):
            acc = acc + inc[:, q, 31]
        off[:, w] = acc
        acc = np.zeros(rows, F32)
        for q in range(WARPS - 1, w, -1):
            acc = acc + sinc[:, q, 0]
        soff[:, w] = acc
    pre = off[..., None] + pre_l
    suf = soff[..., None] + suf_l
    return pre.reshape(rows, THREADS), suf.reshape(rows, THREADS)


class SortedChunk:
    """One sorted chunk as the slot sums read it: keys, values (rows,
    TILE), the strip sums and the sums of the strips before and after each
    strip."""

    def __init__(self, sk, vals, valid):
        self.sk, self.v, self.valid = sk, vals, valid
        self.gs = seq_sum(vals.reshape(vals.shape[0], THREADS, ITEMS))
        self.pre, self.suf = strip_scans(self.gs)

    def sum(self, a, b):
        """The kernel's sum of each row over the sorted positions [a, b):
        in one strip, its values in order; from position 0, the strips
        before (pre) then b-1's strip up to b-1; up to the last element,
        a's strip from a then the strips after (suf); else a's strip from
        a, each strip between in order, then b-1's strip up to b-1."""
        ga, gb = a // ITEMS, (b - 1) // ITEMS
        v = self.v
        if ga == gb:
            return seq_sum(v[:, a:b])
        if a == 0:
            return self.pre[:, gb] + seq_sum(v[:, gb * ITEMS:b])
        head = seq_sum(v[:, a:(ga + 1) * ITEMS])
        if b == self.valid:
            return head + self.suf[:, ga]
        for g in range(ga + 1, gb):
            head = head + self.gs[:, g]
        return head + seq_sum(v[:, gb * ITEMS:b])


def ladder_chunk(chunk, edges):
    """One ladder's counts and sums (rows, nslots) over one sorted chunk:
    slot s holds the sorted positions [p_{s-1}, p_s), p_s the elements
    whose key is at most the key of edge s."""
    ne = edges.size
    bnd = np.searchsorted(chunk.sk, edge_key(edges), side="right")
    lo = np.concatenate([[0], bnd])
    hi = np.concatenate([bnd, [chunk.valid]])
    cnt = hi - lo
    sums = np.zeros((chunk.v.shape[0], ne + 1), F32)
    for s in np.flatnonzero(cnt > 0):
        sums[:, s] = chunk.sum(lo[s], hi[s])
    return cnt, sums


def model(x, w, edges, nblk=None):
    """The kernel's counts (K, nslots) and block partials (nblk, K, rows,
    nslots) for ``x`` (n,) f32, ``w`` (n,) f32 or None (K3s), ``edges``
    (K, nedges) f32: chunk c belongs to block c % nblk, and a block adds
    its chunks' sums in chunk order."""
    x = np.asarray(x, F32)
    n = x.size
    edges = np.asarray(edges, F32)
    k, ne = edges.shape
    rows = 1 if w is None else 2
    nblk = cpo.fg_blocks(n) if nblk is None else nblk
    cnt = np.zeros((k, ne + 1), np.int64)
    part = np.zeros((nblk, k, rows, ne + 1), F32)
    for c in range(-(-n // TILE)):
        sl = slice(c * TILE, min((c + 1) * TILE, n))
        xs = x[sl]
        valid = xs.size
        sk, sw = sort_chunk(order_key(xs), xs if w is None
                            else np.asarray(w, F32)[sl])
        ok = np.arange(TILE) < valid
        xv = np.where(ok, key_value(sk), F32(0))
        if w is None:
            vals = xv[None]
        else:
            wv = np.where(ok, sw, F32(0))
            vals = np.stack([wv, np.where(ok, wv * xv, F32(0))])
        chunk = SortedChunk(sk, vals, valid)
        for j in range(k):
            cj, sj = ladder_chunk(chunk, edges[j])
            cnt[j] += cj
            written = cj > 0
            part[c % nblk, j][:, written] = (part[c % nblk, j][:, written]
                                             + sj[:, written])
    return cnt, part


def model_sums(x, w, edges):
    """The model's outputs as the wrappers return them (block partials
    summed in f64: exact on integer data)."""
    cnt, part = model(x, w, edges)
    s = part.astype(np.float64).sum(axis=0).astype(F32)
    return (cnt,) + tuple(s[:, r] for r in range(s.shape[1]))


# ---------------------------------------------------------------------------
# data and ladders
# ---------------------------------------------------------------------------


def _special(rng, n, scale=1.0):
    """randn with ±0, ±inf, NaN of either sign, denormals and ±3e38."""
    x = (rng.standard_normal(n) * scale).astype(F32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-44,
                        1e-39, -3e-39, 3e38, -3e38], F32)
    neg_nan = np.array([0xFFC00001], U32).view(F32)
    x[rng.choice(n, size=48, replace=False)] = np.concatenate(
        [np.tile(special, 4), np.tile(neg_nan, 4)])
    return x


def _int_data(rng, n):
    """Integer-valued x (-4..4, zeros at density 7/8) with ±inf, NaN and
    ±0 planted: every slot sum is exact in any order."""
    x = rng.integers(-4, 5, n).astype(F32)
    x[rng.random(n) < 7 / 8] = 0
    x[rng.choice(n, 24, replace=False)] = np.tile(
        np.array([np.inf, -np.inf, np.nan, -0.0], F32), 6)
    return x


def _edges(lo, hi, nbins):
    return tref.bin_edges(torch.tensor(lo, dtype=torch.float32),
                          torch.tensor(hi, dtype=torch.float32),
                          nbins).numpy()


def _polish(lo, hi, cuts, nbins=128):
    k = len(cuts)
    return tsel.polish_edges(torch.full((k,), lo), torch.full((k,), hi),
                             torch.tensor(cuts, dtype=torch.float32),
                             nbins).numpy()


KINDS = [(-3e38, 3e38), (-2.0, 2.0), (-1e-3, 2e-3), (0.25, ONE_UP),
         (-1e-40, 1e-40)]


def _ladders(label):
    """(K, nbins + 1) ladders: the five bracket kinds cycled over 16, the
    first sweep's 16 identical ladders, 16 polish ladders over one bracket
    with distinct cuts, and narrow ladders around one cut each."""
    if label == "cycled":
        return np.stack([_edges(*KINDS[j % 5], 128) for j in range(16)])
    if label == "identical":
        return np.stack([_edges(-4.0, 4.0, 128)] * 16)
    if label == "polish":
        return _polish(-4.0, 4.0, np.linspace(-1.5, 1.5, 16))
    cuts = np.linspace(-1.0, 1.0, 16)
    return np.stack([_edges(c - 0.02, c + 0.01, 128) for c in cuts])


# ---------------------------------------------------------------------------
# the key map and the slots
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("label,lo,hi,nbins,normal", [
    ("data scale", -2.0, 2.0, 128, True),
    ("full range", -3e38, 3e38, 128, True),
    ("narrow", -1e-3, 2e-3, 128, True),
    ("one ulp", 0.25, ONE_UP, 128, True),
    ("denormal", -1e-40, 1e-40, 128, False),
    ("zero width", 0.0, 0.0, 128, True),
    ("wide", -2.0, 2.0, 8192, True)])
def test_key_slots_equal_the_slot_oracles(label, lo, hi, nbins, normal):
    rng = np.random.default_rng(nbins + len(label))
    scale = {"narrow": 1e-3, "denormal": 1e-40}.get(label, 1.0)
    x = _special(rng, 20_000, scale)
    if label == "one ulp":
        x[:2000], x[2000:4000] = F32(0.25), F32(ONE_UP)
    e = _edges(lo, hi, nbins)
    got = key_slots(x, e)
    want = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, want)
    if normal:  # the reference flushes denormal x: held on the others
        jslots = np.asarray(jref.searchsorted_slots(jnp.asarray(x),
                                                    jnp.asarray(e)))
        jslots = np.where(np.isnan(x), nbins + 1, jslots)
        keep = ~((x != 0) & (np.abs(x) < np.finfo(F32).tiny))
        np.testing.assert_array_equal(got[keep], jslots[keep])


def test_key_slots_on_polish_ladders():
    rng = np.random.default_rng(4)
    x = _special(rng, 20_000)
    for e in _polish(-4.0, 4.0, [0.1, -3.9, 0.0, 4.0]):
        want = tref.searchsorted_slots(torch.from_numpy(x),
                                       torch.from_numpy(e)).numpy()
        np.testing.assert_array_equal(key_slots(x, e), want)


def test_key_order_is_the_value_order():
    """Keys order every non-NaN value as its float order, with -0 before
    +0; NaN of either sign sits above +inf and below the padding."""
    rng = np.random.default_rng(5)
    x = _special(rng, 5000)
    fin = x[~np.isnan(x)]
    k = order_key(fin)
    xs = fin[np.argsort(k, kind="stable")]
    assert np.all(xs[1:] >= xs[:-1])
    assert np.all(order_key(x[np.isnan(x)]) == NAN_KEY)
    assert order_key(F32(-0.0)) + 1 == order_key(F32(0.0))
    assert order_key(F32(np.inf)) < NAN_KEY < PAD_KEY
    assert np.array_equal(key_value(k).view(U32), fin.view(U32))


# ---------------------------------------------------------------------------
# the sums
# ---------------------------------------------------------------------------

N_INT = (1 << 15) + 123  # 9 chunks, the last one ragged


@pytest.mark.parametrize("ladders", ["cycled", "identical", "polish",
                                     "narrow"])
def test_sums_equal_plain_on_integers(ladders):
    """Integer x (and integer w): counts, masses and sums bit for bit, NaN
    and inf slots equal with equal_nan."""
    rng = np.random.default_rng(7)
    x = _int_data(rng, N_INT)
    w = rng.integers(0, 4, N_INT).astype(F32)
    e = _ladders(ladders)
    xt, wt, et = (torch.from_numpy(a) for a in (x, w, e))
    cnt, s = model_sums(x, None, e)
    want = tref.cp_histogram_multi_ref(xt, et, want_sums=True)
    np.testing.assert_array_equal(cnt, want[0].numpy())
    np.testing.assert_array_equal(s, want[1].numpy())
    cnt, m, s = model_sums(x, w, e)
    want = tref.wcp_histogram_multi_ref(xt, wt, et, want_sums=True)
    np.testing.assert_array_equal(cnt, want[0].numpy())
    np.testing.assert_array_equal(m, want[1].numpy())
    np.testing.assert_array_equal(s, want[2].numpy())


def _chain(n):
    """The longest chain of f32 additions a value goes through: its strip
    (ITEMS), the strips of a slot (TILE / ITEMS), the block's chunks, and
    the sum over the block partials."""
    nblk = cpo.fg_blocks(n)
    return ITEMS + TILE // ITEMS + -(-(-(-n // TILE)) // nblk) + nblk


@pytest.mark.parametrize("weighted", [False, True])
def test_sums_near_f64_on_randn(weighted):
    rng = np.random.default_rng(8)
    n = (1 << 15) + 7
    x = (rng.standard_normal(n)).astype(F32)
    w = (rng.random(n) + 0.5).astype(F32)
    e = np.concatenate([_ladders("polish")[:6], _ladders("cycled")[:3],
                        _ladders("narrow")[:4]])
    got = model_sums(x, w if weighted else None, e)[-1]
    xd = torch.from_numpy(x).double()
    wd = torch.from_numpy(w).double() if weighted else torch.ones_like(xd)
    et = torch.from_numpy(e)
    exact = tref.wcp_histogram_multi_ref(xd, wd, et)[2].numpy()
    scale = np.abs(tref.wcp_histogram_multi_ref(
        xd, wd * torch.sign(xd), et)[2].numpy())
    err = np.abs(got.astype(np.float64) - exact)
    assert np.all(err <= _chain(n) * 2.0 ** -24 * scale)


@pytest.mark.parametrize("ladders", ["cycled", "identical", "polish",
                                     "narrow"])
def test_ladder_partials_ignore_the_other_ladders(ladders):
    """Dense weights on randn with the specials: each ladder alone, and
    the 16 in another order, give their entries' block partials bit for
    bit (several blocks, a ragged last chunk)."""
    rng = np.random.default_rng(9)
    n = 5 * TILE + 77
    x = _special(rng, n)
    w = (rng.random(n) + 0.5).astype(F32)
    e = _ladders(ladders)
    for weights in (None, w):
        cnt, part = model(x, weights, e, nblk=2)
        for j in (0, 5, 15):
            c1, p1 = model(x, weights, e[j:j + 1], nblk=2)
            assert np.array_equal(cnt[j], c1[0])
            assert np.array_equal(part[:, j].view(U32), p1[:, 0].view(U32))
        perm = np.random.default_rng(10).permutation(16)
        cp, pp = model(x, weights, e[perm], nblk=2)
        assert np.array_equal(cnt[perm], cp)
        assert np.array_equal(part[:, perm].view(U32), pp.view(U32))


def test_slots_on_strip_ends_and_one_value():
    """Chunks whose slots start or end at strip and warp ends: one value
    repeated (one slot over the whole chunk), values that fill whole
    strips, and ladders that hold no element or have zero width."""
    x1 = np.full(TILE, 1.5, F32)
    e1 = np.stack([_edges(-2.0, 2.0, 128), _edges(10.0, 20.0, 128),
                   np.full(129, 1.5, F32)])
    xs = np.repeat(np.linspace(-1.9, 1.9, TILE // ITEMS).astype(F32), ITEMS)
    for x in (x1, xs, np.concatenate([xs, xs[:100]])):
        xt, et = torch.from_numpy(x), torch.from_numpy(e1)
        cnt, s = model_sums(x, None, e1)
        want = tref.cp_histogram_multi_ref(xt.double(), et, want_sums=True)
        scale = tref.wcp_histogram_multi_ref(
            xt.double(), torch.sign(xt.double()), et)[2].numpy()
        np.testing.assert_array_equal(cnt, want[0].numpy())
        err = np.abs(s.astype(np.float64) - want[1].numpy())
        assert np.all(err <= _chain(x.size) * 2.0 ** -24 * scale)


# ---------------------------------------------------------------------------
# the wrapper's layout
# ---------------------------------------------------------------------------


def _layout_words(group, nedges, rows):
    """``Layout::words()`` of ``csrc/hist_multi_sums.cu``, term by term."""
    nslots = nedges + 1
    return (2 * TILE + 3 * rows * THREADS + group * nedges + group * nedges
            + group * rows * nslots + group * nslots)


@pytest.mark.parametrize("group", [1, 2, 16])
@pytest.mark.parametrize("nedges", [2, 3, 65, 129, 1025])
@pytest.mark.parametrize("rows", [1, 2])
def test_smem_is_the_kernel_layout(group, nedges, rows):
    assert cpo.sorted_sums_smem(group, nedges, rows) == 4 * _layout_words(
        group, nedges, rows)


def test_tile_and_smem_at_128_bins():
    assert cpo.SORTED_TILE == cpo.SORTED_THREADS * cpo.SORTED_ITEMS == 4096
    assert cpo.sorted_sums_smem(16, 129, 1) == 68_992
    assert cpo.sorted_sums_smem(16, 129, 2) == 80_384
    assert cpo.sorted_sums_group(16, 129, 2) == 16


@pytest.mark.parametrize("nedges,nrows,design", [
    (129, 1, "sorted"), (129, 2, "sorted"), (2, 1, "sorted"),
    (17, 2, "sorted"), (1025, 1, "sorted"), (1025, 2, "sorted"),
    (8193, 1, "sorted"), (8193, 2, "sorted"), (9650, 2, "sorted"),
    (9651, 2, "grouped"), (12255, 1, "sorted"), (12256, 1, "grouped"),
    (12289, 2, "grouped"), (1, 1, "grouped")])
def test_design_by_width_and_leg(nedges, nrows, design):
    """The sorted tile wherever one ladder a block fits its shared memory,
    static arrays included; the grouped kernel past that, where it still
    fits."""
    assert cpo.hist_multi_sums_layout(nedges, nrows) == design
    if design == "grouped" and nedges > 1:
        assert cpo.sorted_sums_smem(1, nedges, nrows) + \
            cpo.SORTED_STATIC_SMEM > cpo.HIST_OPTIN_SMEM
        assert cpo.whist_layout(1, nedges, nrows)[0] == 1


@pytest.mark.parametrize("k,nedges,nrows,group", [
    (1, 129, 1, 1), (3, 129, 2, 4), (16, 129, 1, 16), (64, 129, 2, 16),
    (16, 1025, 2, 8), (64, 1025, 1, 8), (16, 767, 1, 8), (16, 604, 2, 8),
    (16, 765, 1, 16), (16, 602, 2, 16), (3, 8193, 1, 1), (16, 9650, 2, 1)])
def test_group_by_shared_memory(k, nedges, nrows, group):
    """16 ladders a block of 767 edges (K3s) or 604 (K3ws) fit the dynamic
    layout alone but not with the static arrays: such a block takes 8."""
    got = cpo.sorted_sums_group(k, nedges, nrows)
    assert got == group
    assert cpo.sorted_sums_smem(got, nedges, nrows) + \
        cpo.SORTED_STATIC_SMEM <= cpo.HIST_OPTIN_SMEM


def test_group_raises_where_one_ladder_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        cpo.sorted_sums_group(1, 1 << 15, 2)


def _static_bytes(rows):
    """The bytes of the ``__shared__`` arrays declared in the kernel's
    source, at the leg's ``rows``, from the source's constants."""
    import re
    from pathlib import Path
    src = (Path(cpo.__file__).parent / "csrc" / "hist_multi_sums.cu"
           ).read_text()
    names = {"kMaxGroup": cpo.HIST_MULTI_GROUP,
             "kWarps": cpo.SORTED_THREADS // 32, "R": rows}
    total = 0
    for typ, dims in re.findall(
            r"^\s*__shared__\s+(int|float|unsigned)\s+\w+((?:\[\w+\])*);",
            src, re.M):
        size = 4
        for d in re.findall(r"\[(\w+)\]", dims):
            size *= int(d) if d.isdigit() else names[d]
        total += size
    return total


@pytest.mark.parametrize("rows,nbytes", [(1, 196), (2, 260)])
def test_static_margin_covers_the_kernel_arrays(rows, nbytes):
    assert _static_bytes(rows) == nbytes <= cpo.SORTED_STATIC_SMEM


@pytest.mark.parametrize("nedges", [3, 129, 604, 767, 1025, 8193, 12289])
@pytest.mark.parametrize("nrows", [1, 2])
def test_design_does_not_follow_k(nedges, nrows):
    """The wrapper's launch plan takes a sums leg's kernel library from
    the width and the leg alone: a ladder alone and among 16 or 64 runs
    the same one, and alone a sorted-tile block holds one ladder."""
    plans = [cpo.whist_multi_plan(k, nedges, nrows, True)
             for k in (1, 16, 64)]
    assert len({lib for lib, _, _ in plans}) == 1
    assert plans[0][0] == ("hist_multi_sums" if cpo.hist_multi_sums_layout(
        nedges, nrows) == "sorted" else "hist_multi")
    assert plans[0][1] == 1
    assert cpo.whist_multi_plan(16, nedges, nrows, True,
                                "grouped")[0] == "hist_multi"
    if nedges <= 8193:
        assert cpo.whist_multi_plan(16, nedges, nrows, True,
                                    "sorted")[0] == "hist_multi_sums"
    else:  # one ladder overflows a sorted-tile block
        with pytest.raises(ValueError, match="shared memory"):
            cpo.whist_multi_plan(16, nedges, nrows, True, "sorted")
    # K3w (no sums) stays on the grouped kernel
    assert cpo.whist_multi_plan(16, nedges, 1, False)[0] == "hist_multi"
