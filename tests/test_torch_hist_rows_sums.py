"""K1s's and K1ws's lane-column design (``csrc/hist_batched.cu``,
``lane_sums_kernel``), held on the CPU.

The CUDA kernel runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); here numpy models of it are held against the port's
plain versions (``kernels/ref.py``) and the JAX reference's slot oracle:

* the slot lookup: 1024 buckets uniform over a ladder's bracket (in
  halves, each f32 operation rounded on its own), each bucket holding the
  lowest slot its values can take and that slot's edges; an element's slot
  taken only where the realized edges confirm it (one of two slots), else
  counted by the warp from the edges its lanes hold.  It gives
  ``searchsorted_slots`` on uniform, full-range, narrow, one-ulp, denormal,
  polished and warm (``prior_edges``) ladders, with ±inf and NaN in the
  data, whatever the buckets propose; on randn the proposal decides all but
  a fraction of a percent of the elements;
* the f32 order, operation for operation: group i // 4 of a row to thread
  (i // 4) mod (nblk * threads), batches of 8 groups (K1s) or 4 (K1ws) in
  chunks of 8 elements, then single groups; K1ws's lanes l and l + 16
  sharing a column of (mass, sum) pairs in two sub-steps; the flush's
  columns from the slot's own on, warps in order, ``sum_blocks``.
  Integer data equal the plain versions bit for bit, dense data stay
  within the design's f32 chain, and
  a row's bits do not depend on where the row starts (an odd-n batch puts
  its rows at every alignment), where an assignment of 16-byte packs from
  the row's first aligned address does.
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
NB = cpo.SUMS_BUCKETS
ONE_UP = float(np.nextafter(F32(0.25), F32(1)))
INF = F32(np.inf)


# ---------------------------------------------------------------------------
# the slot lookup
# ---------------------------------------------------------------------------


def _floor_to_int(t):
    """``__float2int_rd``: round down, NaN to 0, saturate to int32."""
    with np.errstate(invalid="ignore"):
        c = np.floor(np.nan_to_num(t, nan=0.0, posinf=2.0 ** 31,
                                   neginf=-2.0 ** 31).astype(np.float64))
    return np.clip(c, -2 ** 31, 2 ** 31 - 1).astype(np.int64)


def bucket_of(v, e):
    """``sums_bucket``: (v / 2 - e_0 / 2) * (NB / (e_nb / 2 - e_0 / 2)),
    each operation rounded to f32, floored and clamped to [0, NB)."""
    with np.errstate(all="ignore"):
        h0 = F32(0.5) * e[0]
        sc = F32(NB) / (F32(0.5) * e[-1] - h0)
        t = (F32(0.5) * np.asarray(v, F32) - h0) * sc
    return np.clip(_floor_to_int(t), 0, NB - 1)


def bucket_table(e):
    """The block's bucket table, as the kernel fills it: every entry slot 1,
    then edge j (1..nb) the buckets above e_{j-1}'s up to its own (the
    first from bucket 0, the last to bucket NB - 1)."""
    nb = e.size - 1
    be = bucket_of(e, e)
    tab = np.ones(NB, np.int64)
    for j in range(1, nb + 1):
        lo = 0 if j == 1 else be[j - 1] + 1
        hi = NB - 1 if j == nb else be[j]
        tab[lo:hi + 1] = j
    return tab


def lookup_slots(x, e, table=None):
    """The kernel's slots of f32 ``x`` against one realized ladder ``e``:
    end slots by two compares; an in-bracket element takes its bucket's
    slot g (``table`` may propose any slots) where e_{g-1} < v <= e_g, g + 1
    where e_g < v <= e_{g+1}, else the warp's count of the edges below it.
    Returns the slots and whether the proposal decided each."""
    x = np.asarray(x, F32)
    nb = e.size - 1
    ep = np.concatenate([e, [INF]]).astype(F32)  # e_{nb+1} pads with +inf
    g = (bucket_table(e) if table is None else table)[bucket_of(x, e)]
    with np.errstate(invalid="ignore"):
        lo, hi = x <= e[0], ~(x <= e[nb])
        hit1 = (ep[g - 1] < x) & (x <= ep[g])
        hit2 = (ep[g] < x) & (x <= ep[g + 1])
        below = (e[None, :] < x[:, None]).sum(axis=1)
    inside = np.where(hit1, g, np.where(hit2, g + 1, below))
    return (np.where(lo, 0, np.where(hi, nb + 1, inside)),
            ~lo & ~hi & (hit1 | hit2))


def _special(rng, n, scale=1.0):
    x = (rng.standard_normal(n) * scale).astype(F32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-44,
                        1e-39, -3e-39, 3e38, -3e38], F32)
    x[rng.choice(n, size=44, replace=False)] = np.tile(special, 4)
    return x


def _bin_edges(lo, hi, nbins=128):
    return tref.bin_edges(torch.tensor(lo, dtype=torch.float32),
                          torch.tensor(hi, dtype=torch.float32),
                          nbins).numpy()


def _polish(lo, hi, cut):
    return tsel.polish_edges(torch.tensor([lo]), torch.tensor([hi]),
                             torch.tensor([cut]), 128)[0].numpy()


def _prior(lo, hi, value):
    v = torch.tensor([value])
    pr = tsel.Prior(value=v, y_lo=v, y_hi=torch.tensor(
        [float(np.nextafter(F32(value), INF))]), cut=v)
    return tsel.prior_edges(torch.tensor([lo]), torch.tensor([hi]), pr,
                            128)[0].numpy()


def _ladders():
    """(label, edges, data scale, normal): the engine's ladders (``normal``:
    no denormal edges, so the reference's flush leaves them alone)."""
    return [("data scale", _bin_edges(-2.0, 2.0), 1.0, True),
            ("full range", _bin_edges(-3e38, 3e38), 1.0, True),
            ("narrow", _bin_edges(-1e-3, 2e-3), 1e-3, True),
            ("one ulp", _bin_edges(0.25, ONE_UP), 1.0, True),
            ("denormal", _bin_edges(-1e-40, 1e-40), 1e-40, False),
            ("odd width", _bin_edges(-1.5, 2.5, 17), 1.0, True),
            ("polished, cut in the middle", _polish(-4.0, 4.0, 0.1), 1.0,
             True),
            ("polished, cut near an end", _polish(-4.0, 4.0, -3.9), 1.0,
             True),
            ("polished, cut at 0", _polish(-4.0, 4.0, 0.0), 1.0, True),
            ("prior", _prior(-4.0, 4.0, 0.3), 1.0, True)]


@pytest.mark.parametrize("label,e,scale,normal", _ladders(),
                         ids=[lad[0] for lad in _ladders()])
def test_lookup_equals_the_slot_oracles(label, e, scale, normal):
    rng = np.random.default_rng(e.size)
    x = _special(rng, 20_000, scale)
    if label == "one ulp":  # values on and around the two distinct edges
        x[:2000] = F32(0.25)
        x[2000:4000] = F32(ONE_UP)
    assert np.all(np.diff(e) >= 0)
    got, _ = lookup_slots(x, e)
    want = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, want)
    if normal:  # the reference flushes denormal x: held on the others
        ref_slots = np.asarray(jref.searchsorted_slots(jnp.asarray(x),
                                                       jnp.asarray(e)))
        ref_slots = np.where(np.isnan(x), e.size, ref_slots)
        keep = ~((x != 0) & (np.abs(x) < np.finfo(F32).tiny))
        np.testing.assert_array_equal(got[keep], ref_slots[keep])


def test_lookup_ignores_wrong_proposals():
    """Whatever slot a bucket proposes (each entry a slot with its own
    edges), the realized edges decide: random, shifted and constant tables
    give the oracle's slots."""
    rng = np.random.default_rng(5)
    e = _polish(-4.0, 4.0, 0.1)
    x = _special(rng, 20_000)
    want = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    tab = bucket_table(e)
    for wrong in (rng.integers(1, 129, NB), np.clip(tab + 3, 1, 128),
                  np.clip(tab - 2, 1, 128), np.full(NB, 128),
                  np.ones(NB, np.int64)):
        got, decided = lookup_slots(x, e, wrong)
        np.testing.assert_array_equal(got, want)
        assert decided.mean() < 0.9  # the search did the rest


@pytest.mark.parametrize("label", ["data scale", "polished, cut in the "
                                   "middle", "prior"])
def test_table_proposes_the_lowest_slot(label):
    """On a sorted ladder each bucket's slot is one more than the interior
    edges of lower buckets, no in-bracket element of the bucket lies in a
    lower slot, and an element lies at most one slot above it unless its
    bucket holds two or more interior edges."""
    e = dict((lad[0], lad[1]) for lad in _ladders())[label]
    nb = e.size - 1
    be = bucket_of(e, e)
    assert np.all(np.diff(be) >= 0)  # monotone on a sorted ladder
    tab = bucket_table(e)
    want = 1 + np.array([(be[1:nb] < b).sum() for b in range(NB)])
    np.testing.assert_array_equal(tab, want)
    x = np.random.default_rng(6).standard_normal(50_000).astype(F32)
    x = x[(x > e[0]) & (x <= e[nb])]
    slot = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    b = bucket_of(x, e)
    assert np.all(slot >= tab[b])
    crowded = np.array([(be[1:nb] == k).sum() >= 2 for k in range(NB)])
    assert np.all((slot <= tab[b] + 1) | crowded[b])


@pytest.mark.parametrize("label,least", [
    ("uniform", 1.0), ("polished at the median", 0.98),
    ("polished at 1.0", 0.98), ("prior at the median", 0.98)])
def test_proposals_decide_nearly_every_element(label, least):
    """On randn the bucket's proposal (one of two slots) decides at least
    ``least`` of the in-bracket elements; the polished ladders' crowded
    edges around the cut leave the rest to the warp's count."""
    x = np.random.default_rng(7).standard_normal(1 << 17).astype(F32)
    lo, hi = float(x.min()), float(x.max())
    med = float(np.median(x))
    e = {"uniform": lambda: _bin_edges(lo, hi),
         "polished at the median": lambda: _polish(lo, hi, med),
         "polished at 1.0": lambda: _polish(lo, hi, 1.0),
         "prior at the median": lambda: _prior(lo, hi, med)}[label]()
    _, decided = lookup_slots(x, e)
    inside = (x > e[0]) & (x <= e[-1])
    assert decided[inside].mean() >= least


# ---------------------------------------------------------------------------
# the f32 order
# ---------------------------------------------------------------------------

GROUP, CHUNK = cpo.SUMS_GROUP, cpo.SUMS_CHUNK


def leg_shape(leg):
    """(f32 rows per slot, lanes a column, warps a block, groups a batch)
    of K1s or K1ws."""
    rows = 1 if leg == "K1s" else 2
    return (rows, rows, cpo.SUMS_WARPS[rows], cpo.SUMS_BATCH_GROUPS[rows])


def tree(v):
    """``warp_sum``: a shuffle-down tree over the last axis (32 lanes);
    lane 0's value."""
    v = np.array(v, F32)
    o = 16
    while o > 0:
        v[..., :32 - o] = v[..., :32 - o] + v[..., o:]
        o //= 2
    return v[..., 0]


def group_chunks(n, nblk, threads, batch, t0, offset=0):
    """The elements of the warp whose lane 0 is thread ``t0``, chunk by
    chunk as the kernel bins them: (32, K) element indices (-1 none).
    Group j (elements 4j .. 4j + 3) belongs to thread j mod (nblk *
    threads); batches of ``batch`` groups while every lane of the warp has
    one (chunks of two groups), then a group at a time.  ``offset`` (where
    the row starts) picks only the load width, never the elements."""
    del offset
    stride = nblk * threads
    ngroups = n // GROUP
    g = t0 + np.arange(32)
    out = []
    while np.all(g + (batch - 1) * stride < ngroups):
        for c in range(0, batch, CHUNK // GROUP):
            idx = [(g + (c + k) * stride)[:, None] * GROUP + np.arange(GROUP)
                   for k in range(CHUNK // GROUP)]
            out.append(np.concatenate(idx, axis=1))
        g = g + batch * stride
    while np.any(g * GROUP < n):
        idx = g[:, None] * GROUP + np.arange(GROUP)
        out.append(np.where(idx < n, idx, -1))
        g = g + stride
    return out


def pack_chunks(n, nblk, threads, batch, t0, offset):
    """The trap: 16-byte packs from the row's first aligned address (the
    row starts ``offset`` elements past one), pack j to thread j mod
    (nblk * threads), the head before it and the tail after the last pack
    one element each to the row's first threads, last."""
    del batch
    stride = nblk * threads
    head = min((GROUP - offset) % GROUP, n)
    npack = (n - head) // GROUP
    lanes = t0 + np.arange(32)
    out = []
    q = lanes.copy()
    while np.any(q < npack):
        idx = head + q[:, None] * GROUP + np.arange(GROUP)
        out.append(np.where((q < npack)[:, None], idx, -1))
        q = q + stride
    extra = np.concatenate([np.arange(head),
                            np.arange(head + npack * GROUP, n)])
    last = np.full((32, 1), -1)
    for lane, t in enumerate(lanes):
        if t < extra.size:
            last[lane, 0] = extra[t]
    out.append(last)
    return out


def lane_sums_model(x, w, e, nblk=None, chunks=group_chunks, offset=0):
    """K1s (``w`` None) or K1ws on one row ``x`` (n,) against ``e``, f32
    operation for f32 operation: the counts and the f32 rows (R, nslots)
    as the wrapper returns them, the mass (K1ws) then the sum."""
    x = np.asarray(x, F32)
    n, nb = x.size, e.size - 1
    nslots = nb + 2
    R, S, warps, batch = leg_shape("K1s" if w is None else "K1ws")
    C = 32 // S
    threads = 32 * warps
    nblk = nblk or cpo.fg_blocks(n)
    if w is None:
        pay = x[None, :]
    else:
        w = np.asarray(w, F32)
        pay = np.stack([w, w * x])  # w*x rounded on its own
    slot = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    part = np.zeros((nblk, R, nslots), F32)
    for b in range(nblk):
        wred = np.zeros((warps, R, nslots), F32)
        for wp in range(warps):
            tab = np.zeros((nb, C, R), F32)
            pb = np.zeros((R, 32), F32)
            pa = np.zeros((R, 32), F32)
            for idx in chunks(n, nblk, threads, batch,
                              b * threads + wp * 32, offset):
                ok = idx >= 0
                ii = np.where(ok, idx, 0)
                s = np.where(ok, slot[ii], -1)
                p = np.where(ok[None], pay[:, ii], F32(0))  # (R, 32, K)
                for u in range(idx.shape[1]):  # end slots in element order
                    pb = pb + np.where(s[:, u] == 0, p[:, :, u], F32(0))
                    pa = pa + np.where(s[:, u] == nb + 1, p[:, :, u], F32(0))
                for sub in range(S):  # lanes sub*C .. sub*C + C - 1
                    lanes = np.arange(sub * C, sub * C + C)
                    for u in range(idx.shape[1]):
                        sl = s[lanes, u]
                        go = (sl >= 1) & (sl <= nb)
                        r, col = sl[go] - 1, lanes[go] % C
                        tab[r, col] = tab[r, col] + p[:, lanes[go], u].T
            wred[wp, :, 0] = tree(pb)
            wred[wp, :, -1] = tree(pa)
            m = np.zeros((nb, R), F32)
            rows = np.arange(nb)
            for j in range(C):  # from the slot's own column on
                m = m + tab[rows, (rows + j) % C]
            wred[wp, :, 1:-1] = m.T
        acc = np.zeros((R, nslots), F32)
        for wp in range(warps):
            acc = acc + wred[wp]
        part[b] = acc
    lanes = np.zeros((32, R, nslots), F32)  # sum_blocks
    for blk in range(nblk):
        lanes[blk % 32] = lanes[blk % 32] + part[blk]
    rows = tree(np.moveaxis(lanes, 0, -1))
    cnt = np.bincount(slot, minlength=nslots)
    return cnt, rows


def _bits(a):
    return np.asarray(a, F32).view(np.int32)


def _int_row(rng, n):
    """-4..4 at density 1/16 with ±inf, NaN and ±0: every partial sum of a
    slot exact in f32, so any order gives the plain version's bits."""
    x = (rng.integers(-4, 5, n) * (rng.random(n) < 1 / 16)).astype(F32)
    x[rng.choice(n, 5, replace=False)] = [np.inf, -np.inf, np.nan, 0.0,
                                          -0.0]
    return x


N_ORDER = 5 * 8192 + 3  # 6 blocks; a ragged last group


@pytest.mark.parametrize("leg", ["K1s", "K1ws"])
@pytest.mark.parametrize("nblk", [None, 1])
def test_order_model_equals_plain_on_integers(leg, nblk):
    """Integer data: the model's counts and rows equal the plain version
    bit for bit (NaN and inf slots included), at the wrapper's block count
    and at one block (several batches a thread, then single groups)."""
    rng = np.random.default_rng(8)
    x = _int_row(rng, N_ORDER)
    w = rng.integers(0, 4, N_ORDER).astype(F32) if leg == "K1ws" else None
    e = _polish(-4.0, 4.0, 0.1)
    cnt, rows = lane_sums_model(x, w, e, nblk)
    xt, et = torch.from_numpy(x)[None], torch.from_numpy(e)[None]
    if w is None:
        want_c, want_s = tref.cp_histogram_batched_ref(xt, et,
                                                       want_sums=True)
        want = [want_s[0].numpy()]
    else:
        want_c, m, s = tref.wcp_histogram_batched_ref(
            xt, torch.from_numpy(w)[None], et, want_sums=True)
        want = [m[0].numpy(), s[0].numpy()]
    np.testing.assert_array_equal(cnt, want_c[0].numpy())
    for got, ref_row in zip(rows, want):
        np.testing.assert_array_equal(got, ref_row)


def _chain(n, nblk, leg):
    """The longest chain of f32 additions a value goes through in the
    lane-column design at length n: its column (S lanes' elements, S = 1
    for K1s and 2 for K1ws), the C = 32 / S columns of its slot, the
    warps, and ``sum_blocks`` (a lane's ceil(nblk / 32) blocks and the
    5-level tree, at most nblk + 5)."""
    _, s, warps, _ = leg_shape(leg)
    per_thread = -(-n // (nblk * 32 * warps))
    return s * (per_thread + GROUP) + 32 // s + warps + nblk + 5


@pytest.mark.parametrize("leg", ["K1s", "K1ws"])
def test_order_model_within_the_chain_on_dense(leg):
    """randn with dense weights: each slot's f32 sum within the design's
    chain * 2^-24 of the f64 sum, relative to its sum of |values|."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal(N_ORDER).astype(F32)
    w = (rng.random(N_ORDER) + 0.5).astype(F32) if leg == "K1ws" else None
    e = _polish(float(x.min()), float(x.max()), float(np.median(x)))
    _, rows = lane_sums_model(x, w, e, 1)
    wd = np.ones(N_ORDER) if w is None else w.astype(np.float64)
    xt = torch.from_numpy(x.astype(np.float64))[None]
    et = torch.from_numpy(e)[None]

    def f64(v):
        return tref.wcp_histogram_batched_ref(
            xt, torch.from_numpy(v)[None], et, want_sums=True)

    exact = f64(wd)[2][0].numpy()
    scale = np.abs(f64(wd * np.sign(x))[2][0].numpy())
    bound = _chain(N_ORDER, 1, leg) * 2.0 ** -24 * scale
    assert np.all(np.abs(rows[-1].astype(np.float64) - exact) <= bound)
    if w is not None:
        mass = f64(wd)[1][0].numpy()
        assert np.all(np.abs(rows[0] - mass) <= _chain(N_ORDER, 1, leg)
                      * 2.0 ** -24 * mass)


@pytest.mark.parametrize("leg", ["K1s", "K1ws"])
def test_row_bits_do_not_follow_the_row_start(leg):
    """In an odd-n batch row r starts r * n elements into the buffer, so
    its rows sit at every alignment: the kernel's elements and order are
    the same at each (the row's bits too), where 16-byte packs from the
    row's first aligned address give another thread each element and, on
    this data, other bits."""
    n = 3 * 8192 + 5
    rng = np.random.default_rng(10)
    x = rng.standard_normal(n).astype(F32)
    w = (rng.random(n) + 0.5).astype(F32) if leg == "K1ws" else None
    e = _polish(float(x.min()), float(x.max()), 0.0)
    nblk = cpo.fg_blocks(n)
    _, _, warps, batch = leg_shape(leg)
    threads = 32 * warps
    offsets = sorted({(r * n) % GROUP for r in range(GROUP)})
    assert offsets == [0, 1, 2, 3]
    for t0 in (0, 32 * 7, (nblk - 1) * threads + threads - 32):
        assigned = [group_chunks(n, nblk, threads, batch, t0, off)
                    for off in offsets]
        for other in assigned[1:]:
            assert all(np.array_equal(a, b) for a, b in zip(assigned[0],
                                                            other))
    bits = [_bits(lane_sums_model(x, w, e, chunks=group_chunks,
                                  offset=off)[1]) for off in offsets]
    assert all(np.array_equal(bits[0], b) for b in bits[1:])
    trap = [_bits(lane_sums_model(x, w, e, chunks=pack_chunks,
                                  offset=off)[1]) for off in offsets]
    assert not all(np.array_equal(trap[0], b) for b in trap[1:])


# ---------------------------------------------------------------------------
# the layout rule
# ---------------------------------------------------------------------------


def _sums_words(nedges, warps, rows):
    """``SumsLayout::words()`` of ``csrc/hist_batched.cu``, term by term:
    the buckets, the padded edges, per warp its f32 table (32 words a
    slot), int count row and ``rows`` reduction rows, the block's
    counts."""
    pad = 1
    while pad < nedges + 1:
        pad *= 2
    nb, nslots = nedges - 1, nedges + 1
    return (4 * NB + pad + warps * (nb * 32 + nslots + rows * nslots)
            + nslots)


@pytest.mark.parametrize("nedges", [2, 3, 17, 64, 65, 127, 128, 129, 132])
@pytest.mark.parametrize("rows", [1, 2])
def test_lane_sums_smem_is_the_kernel_layout(nedges, rows):
    assert cpo.lane_sums_smem(nedges, rows) == 4 * _sums_words(
        nedges, cpo.SUMS_WARPS[rows], rows)
    assert cpo.lane_sums_smem(nedges, rows, 8) == 4 * _sums_words(
        nedges, 8, rows)


@pytest.mark.parametrize("rows", [1, 2])
def test_lane_sums_warps_are_the_most_that_fit(rows):
    """At the engine's 128 bins a block holds the most warps whose tables
    fit (up to the kernel's thread limit), one block an SM."""
    warps = cpo.SUMS_WARPS[rows]
    assert warps <= cpo.SUMS_MAX_WARPS
    assert cpo.lane_sums_smem(129, rows) <= cpo.HIST_OPTIN_SMEM
    assert (warps == cpo.SUMS_MAX_WARPS or
            cpo.lane_sums_smem(129, rows, warps + 1) > cpo.HIST_OPTIN_SMEM)
    assert cpo.blocks_per_sm(cpo.lane_sums_smem(129, rows)) == 1


@pytest.mark.parametrize("nrows", [1, 2])
def test_lane_sums_run_exactly_where_their_block_fits(nrows):
    """The lane-column design takes the sums legs' first sweeps of long
    rows at every width from 2 edges while its block fits and the lanes'
    registers hold the edges; never on a narrow sweep or a short row."""
    big = 1 << 27
    widths = range(2, 400)
    lane = [w for w in widths
            if cpo.hist_rows_layout(w, nrows, big, True, sums=True)
            == "lane_sums"]
    assert lane == list(range(2, lane[-1] + 1))
    assert lane[-1] >= 129 and lane[-1] <= 32 * cpo.SUMS_EDGE_REGS
    assert cpo.lane_sums_smem(lane[-1], nrows) <= cpo.HIST_OPTIN_SMEM
    assert cpo.lane_sums_smem(lane[-1] + 1, nrows) > cpo.HIST_OPTIN_SMEM
    for w in widths:
        assert cpo.hist_rows_layout(w, nrows, big, False, sums=True) == \
            "grouped"
        assert cpo.hist_rows_layout(w, nrows, cpo.LANE_SUMS_MIN_N - 1, True,
                                    sums=True) == "grouped"


def test_layout_is_a_rule_on_the_call():
    """The design follows (nedges, nrows, n, full_bracket) alone: a batch
    of any number of rows of one length takes one design, and K1w keeps
    its own rule."""
    n = 1 << 27
    assert cpo.hist_rows_layout(129, 1, n, True, sums=True) == "lane_sums"
    assert cpo.hist_rows_layout(129, 2, n, True) == "lane_sums"
    assert cpo.hist_rows_layout(129, 1, n, True) == "lane"
    assert cpo.hist_rows_layout(129, 1, cpo.LANE_ROWS_MIN_N - 1, True) == \
        "grouped"
