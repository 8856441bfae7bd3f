"""K1's design rules, held on the CPU.

K1 (``csrc/hist_batched.cu``) picks its design from the ladder's width
alone (``cp_objective.hist_rows_layout``), sizes its grid with
``hist_blocks_per_row`` and its lane-private blocks with
``lane_hist_smem``; these are plain functions of shapes, checked here
against the kernel's layout arithmetic.  The lane-private kernel's slot
rule (a guess from the ladder's end points, taken only if the realized
edges agree, else a branch-free search over the edges padded with +inf)
is modelled in numpy f32 and held against the port's plain slot oracle
and the JAX reference's, on the engine's ladders: uniform, full-range,
one-ulp (duplicated edges), denormal and polish ladders, and with guesses
that are wrong on purpose.  The CUDA kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
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


H100_SMS = 132
ONE_UP = float(np.nextafter(np.float32(0.25), np.float32(1)))


def _layout_words(nedges, warps, rows):
    """``LaneLayout::words()`` of ``csrc/hist_batched.cu``, term by term."""
    pad = 1
    while pad < nedges:
        pad *= 2
    nb, nwords, nslots = nedges - 1, nedges // 2, nedges + 1
    return (pad + warps * 32 * nb * rows + warps * 32 * nwords
            + warps * nslots * rows + nslots)


@pytest.mark.parametrize("nedges", [2, 3, 17, 64, 65, 129, 257, 300])
@pytest.mark.parametrize("rows", [0, 1])
def test_lane_smem_is_the_kernel_layout(nedges, rows):
    assert cpo.lane_hist_smem(nedges, rows) == 4 * _layout_words(
        nedges, cpo.LANE_WARPS, rows)


def test_lane_smem_at_128_bins():
    """The engine's 128 bins: K1's block fits three times in an SM's
    shared memory, K1w's and K1s's once."""
    assert cpo.lane_hist_smem(129, 0) == 67_080
    assert cpo.lane_hist_smem(129, 1) == 202_312
    assert cpo.blocks_per_sm(cpo.lane_hist_smem(129, 0)) == 3
    assert cpo.blocks_per_sm(cpo.lane_hist_smem(129, 1)) == 1
    assert cpo.blocks_per_sm((2 * 129 + 1) * 4) == cpo.HIST_BLOCKS_PER_SM


BIG = 1 << 27


@pytest.mark.parametrize("nedges,nrows,n,full,design", [
    (129, 0, BIG, True, "lane"), (129, 0, 1 << 16, True, "lane"),
    (129, 0, BIG, False, "shared"), (129, 1, BIG, True, "lane"),
    (129, 1, BIG, False, "grouped"), (129, 1, 1 << 20, True, "grouped"),
    (129, 1, (1 << 23) - 1, True, "grouped"), (129, 1, 1 << 23, True, "lane"),
    (129, 2, BIG, True, "grouped"), (17, 0, BIG, True, "lane"),
    (17, 1, BIG, True, "lane"), (8193, 0, BIG, True, "shared"),
    (8193, 1, BIG, True, "grouped"), (8193, 2, BIG, True, "grouped"),
    (1, 0, BIG, True, "shared"), (1, 1, BIG, True, "grouped")])
def test_layout_by_call(nedges, nrows, n, full, design):
    """The lane-private design takes the sweeps whose bracket holds every
    element, at widths whose tables fit; with f32 rows only from
    LANE_ROWS_MIN_N elements a row."""
    assert cpo.hist_rows_layout(nedges, nrows, n, full) == design


@pytest.mark.parametrize("nrows", [0, 1])
def test_layout_switches_where_the_tables_stop_fitting(nrows):
    """The lane-private design runs exactly while its block fits the most
    shared memory a block may hold."""
    widths = range(2, 1200)
    lane = [w for w in widths
            if cpo.hist_rows_layout(w, nrows, BIG, True) == "lane"]
    assert lane == list(range(2, lane[-1] + 1))
    assert cpo.lane_hist_smem(lane[-1], nrows) <= cpo.HIST_OPTIN_SMEM
    assert cpo.lane_hist_smem(lane[-1] + 1, nrows) > cpo.HIST_OPTIN_SMEM
    assert lane[-1] >= 129


@pytest.mark.parametrize("rows,n,per_sm,want", [
    (1, 1 << 27, 3, 396), (64, 1 << 20, 3, 7), (1, 100, 3, 1),
    (1, 1 << 27, 8, 1056), (65535, 1 << 10, 3, 1)])
def test_hist_blocks_per_row(rows, n, per_sm, want):
    assert cpo.hist_blocks_per_row(rows, n, H100_SMS, per_sm) == want


@pytest.mark.parametrize("rows", [1, 7, 64, 1000, 65535])
@pytest.mark.parametrize("n", [1, 255, 8193, 1 << 24, (1 << 31) - 1])
def test_no_thread_bins_more_than_16_bits_count(rows, n):
    """Lane-private counts are 16-bit: no thread bins more than 65535
    elements of a row, on K1's grid (whole 16-byte packs of up to 8
    elements, and one head or tail element) and on K1w's fg_blocks(n)."""
    bpr = cpo.hist_blocks_per_row(rows, n, H100_SMS, 3)
    stride = bpr * cpo.HIST_THREADS
    for pack in (4, 8):  # f32, bf16
        packs = -(-(n // pack) // stride)
        assert packs * pack + 1 <= 65535
    assert -(-n // stride) <= cpo.LANE_MAX_PER_THREAD
    nblk = cpo.fg_blocks(n)
    assert -(-n // (nblk * cpo.HIST_THREADS)) <= cpo.LANE_MAX_PER_THREAD


def _ceil_to_int(t):
    """``__float2int_ru``: round up, NaN to 0, saturate to int32."""
    with np.errstate(invalid="ignore"):
        c = np.ceil(np.nan_to_num(t, nan=0.0, posinf=2.0 ** 31,
                                  neginf=-2.0 ** 31).astype(np.float64))
    return np.clip(c, -2 ** 31, 2 ** 31 - 1).astype(np.int64)


def _lane_slots(x, e, guess=None):
    """The lane-private kernel's slots of f32 ``x`` against one realized
    f32 ladder ``e``: end slots by two compares, in-bracket slots by the
    guess (or ``guess``, any ints) checked against the realized edges, or
    else the branch-free search over the padded edges."""
    f = np.float32
    nb = e.size - 1
    pad = 1 << (e.size - 1).bit_length()
    ep = np.full(pad, np.inf, np.float32)
    ep[:e.size] = e
    with np.errstate(all="ignore"):
        h0 = f(0.5) * e[0]
        sc = f(nb) / (f(0.5) * e[nb] - h0)
        g = _ceil_to_int((f(0.5) * x - h0) * sc)
    g = np.clip(g if guess is None else guess, 1, nb)
    with np.errstate(invalid="ignore"):
        hit = (ep[g - 1] < x) & (x <= ep[g])
        j = np.zeros(x.shape, np.int64)
        step = pad // 2
        while step:
            j = np.where(ep[j + step] < x, j + step, j)
            step //= 2
        inside = np.where(hit, g, j + 1)
        return np.where(x <= e[0], 0,
                        np.where(~(x <= e[nb]), nb + 1, inside))


def _special(rng, n, scale=1.0):
    x = (rng.standard_normal(n) * scale).astype(np.float32)
    special = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-44,
                        1e-39, -3e-39, 3e38, -3e38], np.float32)
    x[rng.choice(n, size=44, replace=False)] = np.tile(special, 4)
    return x


def _ladders():
    """(label, lo, hi, nbins, normal): the bracket kinds of the engine's
    sweeps (``normal``: no denormal edges, so the reference's flush
    leaves them alone)."""
    return [("data scale", -2.0, 2.0, 128, True),
            ("full range", -3e38, 3e38, 128, True),
            ("narrow", -1e-3, 2e-3, 128, True),
            ("one ulp", 0.25, ONE_UP, 128, True),
            ("denormal", -1e-40, 1e-40, 128, False),
            ("odd width", -1.5, 2.5, 17, True),
            ("wide", -2.0, 2.0, 8192, True)]


@pytest.mark.parametrize("label,lo,hi,nbins,normal", _ladders())
def test_lane_slot_rule_equals_the_slot_oracles(label, lo, hi, nbins,
                                                normal):
    rng = np.random.default_rng(nbins)
    scale = {"narrow": 1e-3, "one ulp": 1.0, "denormal": 1e-40}.get(label,
                                                                     1.0)
    x = _special(rng, 20_000, scale)
    if label == "one ulp":  # values on and around the two distinct edges
        x[:2000] = np.float32(0.25)
        x[2000:4000] = np.float32(ONE_UP)
    e = tref.bin_edges(torch.tensor(lo, dtype=torch.float32),
                       torch.tensor(hi, dtype=torch.float32), nbins).numpy()
    got = _lane_slots(x, e)
    want = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(got, want)
    if normal:  # the reference flushes denormal x: held on the others
        ref_slots = np.asarray(jref.searchsorted_slots(jnp.asarray(x),
                                                       jnp.asarray(e)))
        ref_slots = np.where(np.isnan(x), nbins + 1, ref_slots)
        keep = ~((x != 0) & (np.abs(x) < np.finfo(np.float32).tiny))
        np.testing.assert_array_equal(got[keep], ref_slots[keep])


def test_lane_slot_rule_ignores_wrong_guesses():
    """Whatever the guess, the realized edges decide: random and
    off-by-one guesses give the oracle's slots."""
    rng = np.random.default_rng(3)
    x = _special(rng, 20_000)
    e = tref.bin_edges(torch.tensor(-2.0), torch.tensor(2.0), 128).numpy()
    want = tref.searchsorted_slots(torch.from_numpy(x),
                                   torch.from_numpy(e)).numpy()
    for guess in (rng.integers(-5, 140, x.size),
                  np.clip(want + 1, 1, 128), np.clip(want - 1, 1, 128)):
        np.testing.assert_array_equal(_lane_slots(x, e, guess), want)


def test_lane_slot_rule_on_polish_ladders():
    """Polish ladders are not uniform: half their edges crowd around the
    cut, so the guess misses there and the search decides."""
    rng = np.random.default_rng(4)
    x = _special(rng, 20_000)
    lo, hi = torch.tensor([-4.0]), torch.tensor([4.0])
    for cut in (0.1, -3.9, 0.0):
        e = tsel.polish_edges(lo, hi, torch.tensor([cut]), 128)[0].numpy()
        assert np.all(np.diff(e) >= 0)
        want = tref.searchsorted_slots(torch.from_numpy(x),
                                       torch.from_numpy(e)).numpy()
        np.testing.assert_array_equal(_lane_slots(x, e), want)
