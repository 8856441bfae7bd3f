"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false.  On a GPU machine run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``;
the first test builds the kernels with nvcc.  No JAX needed.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import objective, selection  # noqa: E402
from repro_torch.kernels import cp_objective, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _data(rows, n, seed, device):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, n)).astype(np.float32)
    x[:, :9] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-44, -1e-39, 3e38,
                -3e38]
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", [(1, 100_003), (7, 5000)])
def test_histogram_kernel_equals_plain(cuda, dtype, rows, n):
    x = _data(rows, n, rows, cuda).to(dtype)
    lo = torch.tensor([-3e38, -2.0, 0.25, -1e-40, -1e-3, 0.0, -1.0][:rows],
                      device=cuda)
    hi = torch.tensor([3e38, 2.0, float(np.nextafter(np.float32(0.25),
                                                     np.float32(1))),
                       1e-40, 2e-3, 0.0, 1.0][:rows], device=cuda)
    edges = ref.bin_edges(lo, hi, 128).contiguous()
    got, _ = cp_objective.cp_histogram_batched(x, edges)
    want, _ = ref.cp_histogram_batched_ref(x, edges, want_sums=False)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_partials_kernel_equals_plain(cuda, dtype):
    x = _data(5, 70_001, 3, cuda).to(dtype)
    y = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38], device=cuda)
    got = cp_objective.cp_partials_batched(x, y)
    want = ref.cp_partials_batched_ref(x, y)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0, equal_nan=True)


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_strided_views_reach_the_kernels(cuda, method):
    x = torch.randn((3, 1 << 17), device=cuda)
    kernel = {"binned": "cp_histogram_batched",
              "cp": "cp_partials_batched"}[method]
    cp_objective.reset_launches()
    res = selection.median(x[0, ::2], method=method)
    assert cp_objective.LAUNCHES[kernel] > 0
    assert float(res.value) == float(
        torch.sort(x[0, ::2]).values[(1 << 16) // 2 - 1])
    ks = torch.tensor([1, 777, 1 << 16], device=cuda)
    res = selection.select_rows(x[:, : 1 << 16], ks, method=method)
    want = torch.gather(torch.sort(x[:, : 1 << 16], dim=1).values, 1,
                        (ks - 1)[:, None])[:, 0]
    assert torch.equal(res.value, want)


def test_main_path_launches_kernels(cuda):
    x = torch.randn(1 << 17, device=cuda)
    want = torch.sort(x).values
    cp_objective.reset_launches()
    res = selection.median(x)
    assert cp_objective.LAUNCHES["cp_histogram_batched"] == int(res.iters)
    assert float(res.value) == float(want[(x.numel() + 1) // 2 - 1])
    cp_objective.reset_launches()
    res = selection.order_statistic(x[:5000], 77)
    assert cp_objective.LAUNCHES["cp_partials_batched"] == int(res.iters)
    assert float(res.value) == float(torch.sort(x[:5000]).values[76])


def _ladders(k, device, nbins=128):
    """K ladders cycling through full-range, data-scale, one-ulp,
    denormal and narrow brackets, with every fourth ladder a repeat of the
    data-scale one (identical ladders, as in a first sweep)."""
    kinds = [(-3e38, 3e38), (-2.0, 2.0),
             (0.25, float(np.nextafter(np.float32(0.25), np.float32(1)))),
             (-1e-40, 1e-40), (-1e-3, 2e-3)]
    pick = [kinds[1] if j % 4 == 3 else kinds[j % len(kinds)]
            for j in range(k)]
    lo = torch.tensor([p[0] for p in pick], device=device)
    hi = torch.tensor([p[1] for p in pick], device=device)
    return ref.bin_edges(lo, hi, nbins).contiguous()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,nbins", [(1, 128), (16, 128), (64, 128),
                                     (3, 8192)])
def test_multi_histogram_kernel_equals_plain(cuda, dtype, k, nbins):
    """K = 64 runs four groups of 16 ladders; 8192 bins need more than the
    48 KB of shared memory a block gets without opting in."""
    x = _data(1, 100_003, k, cuda)[0].to(dtype)
    edges = _ladders(k, cuda, nbins)
    got, _ = cp_objective.cp_histogram_multi(x, edges)
    want, _ = ref.cp_histogram_multi_ref(x, edges, want_sums=False)
    assert torch.equal(got, want)
    one, _ = cp_objective.cp_histogram(x, edges[-1])
    assert torch.equal(one, want[-1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 16, 64])
def test_multi_partials_kernel_equals_plain(cuda, dtype, k):
    x = _data(1, 100_003, k + 1, cuda)[0].to(dtype)
    pivots = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5, -2.0],
                          device=cuda)
    y = pivots[torch.arange(k, device=cuda) % pivots.numel()]
    y[-1] = x[12345].float()  # a pivot on a data value
    got = cp_objective.cp_partials_multi(x, y)
    want = ref.cp_partials_multi_ref(x, y)
    for g, w in zip(got[2:], want[2:]):
        assert torch.equal(g, w)
    for g, w in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0, equal_nan=True)
    # K = 1: the scalar view, and K2's partials bit for bit
    one = cp_objective.cp_partials(x, y[-1])
    rows = cp_objective.cp_partials_batched(x[None, :], y[-1:])
    for a, b in zip(one, rows):
        assert torch.equal(a, b[0]) or (a.isnan() and b[0].isnan())


def test_quantiles_launch_one_sweep_for_all_targets(cuda):
    x = torch.randn(1 << 18, device=cuda)
    qs = np.arange(1, 17) / 17
    cp_objective.reset_launches()
    res = selection.quantiles(x, qs)
    assert cp_objective.LAUNCHES["cp_histogram_multi"] == int(res.iters.max())
    assert cp_objective.LAUNCHES["cp_histogram_batched"] == 0
    ks = selection.ranks_from_quantiles(qs, x.numel()).to(cuda).long()
    assert torch.equal(res.value, torch.sort(x).values[ks - 1])
    cp_objective.reset_launches()
    res = selection.quantiles(x[:5000], qs)  # the cp leg
    assert cp_objective.LAUNCHES["cp_partials_multi"] == int(res.iters.max())
    ks = selection.ranks_from_quantiles(qs, 5000).to(cuda).long()
    assert torch.equal(res.value, torch.sort(x[:5000]).values[ks - 1])


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_strided_view_reaches_the_multi_kernels(cuda, method):
    x = torch.randn(1 << 18, device=cuda)
    kernel = {"binned": "cp_histogram_multi", "cp": "cp_partials_multi"}
    ks = torch.tensor([1, 777, 1 << 16, 1 << 17], device=cuda)
    cp_objective.reset_launches()
    res = selection.multi_order_statistic(x[::2], ks, method=method)
    assert cp_objective.LAUNCHES[kernel[method]] > 0
    assert torch.equal(res.value, torch.sort(x[::2]).values[ks - 1])


# ---------------------------------------------------------------------------
# the weighted legs K1w-K4w
# ---------------------------------------------------------------------------

WDTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
           (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16)]


def _int_weights(shape, seed, device):
    """Integer weights 0..3 (exact in bf16 and in every f32 partial sum
    here), with a run of zeros long enough to empty whole slots."""
    g = torch.Generator(device=device).manual_seed(seed)
    w = torch.randint(0, 4, shape, generator=g, device=device).float()
    w[..., 100:3000] = 0.0
    return w


def _dense_weights(shape, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(shape, generator=g, device=device) + 0.5


@pytest.mark.parametrize("xdt,wdt", WDTYPES)
@pytest.mark.parametrize("rows,n", [(1, 100_003), (7, 5000)])
def test_weighted_histogram_kernel_equals_plain(cuda, xdt, wdt, rows, n):
    x = _data(rows, n, rows, cuda).to(xdt)
    w = _int_weights((rows, n), rows, cuda).to(wdt)
    kinds = [(-3e38, 3e38), (-2.0, 2.0), (-1e-40, 1e-40), (-1e-3, 2e-3),
             (0.25, float(np.nextafter(np.float32(0.25), np.float32(1)))),
             (0.0, 0.0), (-1.0, 1.0)]
    lo = torch.tensor([k[0] for k in kinds[:rows]], device=cuda)
    hi = torch.tensor([k[1] for k in kinds[:rows]], device=cuda)
    edges = ref.bin_edges(lo, hi, 128).contiguous()
    cnt, wcnt, none = cp_objective.wcp_histogram_batched(x, w, edges)
    want = ref.wcp_histogram_batched_ref(x, w, edges, want_sums=False)
    assert none is None
    assert torch.equal(cnt, want[0]) and torch.equal(wcnt, want[1])


@pytest.mark.parametrize("xdt,wdt", WDTYPES)
def test_weighted_partials_kernel_equals_plain(cuda, xdt, wdt):
    x = _data(5, 70_001, 3, cuda).to(xdt)
    w = _int_weights((5, 70_001), 3, cuda).to(wdt)
    y = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38], device=cuda)
    got = cp_objective.wcp_partials_batched(x, w, y)
    want = ref.wcp_partials_batched_ref(x, w, y)
    for g, v in zip(got[2:], want[2:]):  # masses (integers) and counts
        assert torch.equal(g, v)
    for g, v in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, v, rtol=1e-4, atol=0, equal_nan=True)


@pytest.mark.parametrize("xdt,wdt", WDTYPES)
@pytest.mark.parametrize("k,nbins", [(1, 128), (16, 128), (64, 128),
                                     (3, 8192)])
def test_weighted_multi_histogram_kernel_equals_plain(cuda, xdt, wdt, k,
                                                      nbins):
    """K = 16 at 128 bins opts in past 48 KB of shared memory (a mass row
    per warp and ladder); 8192 bins run one ladder on four warps."""
    x = _data(1, 100_003, k, cuda)[0].to(xdt)
    w = _int_weights((100_003,), k, cuda).to(wdt)
    edges = _ladders(k, cuda, nbins)
    cnt, wcnt, _ = cp_objective.wcp_histogram_multi(x, w, edges)
    want = ref.wcp_histogram_multi_ref(x, w, edges, want_sums=False)
    assert torch.equal(cnt, want[0]) and torch.equal(wcnt, want[1])
    one = cp_objective.wcp_histogram(x, w, edges[-1])
    assert torch.equal(one[0], want[0][-1])
    assert torch.equal(one[1], want[1][-1])


@pytest.mark.parametrize("xdt,wdt", WDTYPES)
@pytest.mark.parametrize("k", [1, 16, 64])
def test_weighted_multi_partials_kernel_equals_plain(cuda, xdt, wdt, k):
    x = _data(1, 100_003, k + 1, cuda)[0].to(xdt)
    w = _int_weights((100_003,), k, cuda).to(wdt)
    pivots = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5, -2.0],
                          device=cuda)
    y = pivots[torch.arange(k, device=cuda) % pivots.numel()]
    y[-1] = x[12345].float()  # a pivot on a data value
    got = cp_objective.wcp_partials_multi(x, w, y)
    want = ref.wcp_partials_multi_ref(x, w, y)
    for g, v in zip(got[2:], want[2:]):
        assert torch.equal(g, v)
    for g, v in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, v, rtol=1e-4, atol=0, equal_nan=True)
    # K = 1: the scalar view, and K2w's partials bit for bit
    one = cp_objective.wcp_partials(x, w, y[-1])
    rows = cp_objective.wcp_partials_batched(x[None, :], w[None, :], y[-1:])
    for a, b in zip(one, rows):
        assert torch.equal(a, b[0]) or (a.isnan() and b[0].isnan())


def test_weighted_kernels_repeat_bit_for_bit(cuda):
    """Dense random weights: no order of f32 sums is exact, so the masses
    must come out of a fixed order — two launches, identical bits."""
    n = 1 << 20
    x = torch.randn(n, device=cuda)
    w = _dense_weights(n, 5, cuda)
    e1 = ref.bin_edges(x.min(), x.max(), 128).contiguous()
    e16 = e1[None, :].expand(16, -1).contiguous()
    y16 = torch.linspace(-2.0, 2.0, 16, device=cuda)
    calls = {
        "K1w": lambda: cp_objective.wcp_histogram_batched(
            x[None], w[None], e1[None])[1],
        "K2w": lambda: torch.stack(cp_objective.wcp_partials_batched(
            x[None], w[None], y16[:1])[:4]),
        "K3w": lambda: cp_objective.wcp_histogram_multi(x, w, e16)[1],
        "K4w": lambda: torch.stack(cp_objective.wcp_partials_multi(
            x, w, y16)[:4]),
    }
    for name, call in calls.items():
        a, b = call(), call()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    # against f64 (exact slot sums): within the rounding of the f32 sums
    cnt, wcnt, _ = cp_objective.wcp_histogram_batched(x[None], w[None],
                                                      e1[None])
    exact = ref.wcp_histogram_batched_ref(x[None], w[None].double(),
                                          e1[None], want_sums=False)[1]
    torch.testing.assert_close(wcnt.double(), exact, rtol=1e-4, atol=0)


# K4 and K4w: a pivot's partials do not depend on its launch

K4_PIVOTS = [0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5, -2.0, 0.7, -0.0, -1e-39,
             2.5, -3e38, 0.25, -1.0, 1e-30, 4.0]
NONFINITE = [float("inf"), float("-inf"), float("nan")]


def _k4_call(weighted, x, w):
    if weighted:
        return lambda y: cp_objective.wcp_partials_multi(x, w, y)
    return lambda y: cp_objective.cp_partials_multi(x, y)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["K4", "K4w"])
@pytest.mark.parametrize("nonfinite", [False, True],
                         ids=["finite", "nonfinite"])
def test_multi_partials_ignore_pivot_order_and_company(cuda, weighted,
                                                        nonfinite):
    """16 pivots twice, permuted, and each alone (K = 1): the same bits,
    sums included, with dense weights on 1024 blocks (the most a launch
    has; a block-sum order that followed K showed here).  Non-finite
    pivots send their group down the general path, and a permutation
    mixes the two paths' pivots."""
    n = (1 << 23) + 3
    assert cp_objective.fg_blocks(n) == cp_objective.FG_MAX_BLOCKS
    x = _data(1, n, 9, cuda)[0]
    w = _dense_weights(n, 9, cuda)
    y = torch.tensor(K4_PIVOTS, device=cuda)
    y[-1] = x[12345]
    if nonfinite:
        y[3:6] = torch.tensor(NONFINITE, device=cuda)
    call = _k4_call(weighted, x, w)
    got, again = call(y), call(y)
    perm = torch.randperm(16, generator=torch.Generator(device=cuda)
                          .manual_seed(3), device=cuda)
    permuted = call(y[perm])
    for a, b, c in zip(got, again, permuted):
        assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(a[perm]), _bits(c))
    for j in range(16):
        for a, b in zip(got, call(y[j:j + 1])):
            assert torch.equal(_bits(a[j:j + 1]), _bits(b))


@pytest.mark.parametrize("outer,nblk,inner", [(1, 1024, 64), (64, 128, 2),
                                               (3, 7, 5), (1, 33, 1)])
def test_sum_blocks_equals_the_sum_and_ignores_company(cuda, outer, nblk,
                                                       inner):
    """The block sums of K2 and K4: within the f32 chain of the exact sum,
    two launches identical, and each column the same bits when summed
    alone (the order depends on the block count only)."""
    g = torch.Generator(device=cuda).manual_seed(nblk)
    part = torch.rand((outer, nblk, inner), generator=g, device=cuda) * 100
    got = cp_objective._sum_blocks(part)
    chain = nblk // 32 + 1 + 5  # a lane's serial adds, then the shuffles
    torch.testing.assert_close(got.double(), part.double().sum(1),
                               rtol=chain * 2.0 ** -24, atol=0)
    assert torch.equal(_bits(got), _bits(cp_objective._sum_blocks(part)))
    for j in range(inner):
        alone = cp_objective._sum_blocks(part[:, :, j:j + 1].contiguous())
        assert torch.equal(_bits(got[:, j:j + 1]), _bits(alone))


@pytest.mark.parametrize("weighted", [False, True], ids=["K4", "K4w"])
@pytest.mark.parametrize("k", [1, 2, 5, 16, 17, 64])
def test_multi_partials_any_k_equals_plain(cuda, weighted, k):
    """Every group size the kernel picks, groups of 16 along grid.y and a
    ragged last group, at an n that is a multiple of no grid stride (the
    tail loops run): counts (and integer masses) equal the plain version,
    sums within 1e-4."""
    n = (1 << 20) + 3
    x = _data(1, n, k, cuda)[0]
    w = _int_weights((n,), k, cuda)
    piv = torch.tensor(K4_PIVOTS, device=cuda)
    y = piv[torch.arange(k, device=cuda) % piv.numel()]
    y[-1] = x[12345]
    if weighted:
        got = cp_objective.wcp_partials_multi(x, w, y)
        want = ref.wcp_partials_multi_ref(x, w, y)
    else:
        got = cp_objective.cp_partials_multi(x, y)
        want = ref.cp_partials_multi_ref(x, y)
    for g, v in zip(got[2:], want[2:]):
        assert torch.equal(g, v)
    for g, v in zip(got[:2], want[:2]):
        torch.testing.assert_close(g, v, rtol=1e-4, atol=0, equal_nan=True)


def test_weighted_paths_launch_only_weighted_kernels(cuda):
    n = 1 << 17
    x = torch.randn(n, device=cuda)
    w = torch.randint(0, 2, (n,), device=cuda).float()
    xs, order = torch.sort(x)
    cum = torch.cumsum(w[order].double(), 0)

    def oracle(wk):
        i = int(torch.searchsorted(cum, torch.tensor([wk], device=cuda,
                                                     dtype=torch.float64)))
        return float(xs[min(i, n - 1)])

    W = float(w.sum())
    for call, key, small in (
            (lambda: selection.weighted_median(x, w),
             "wcp_histogram_batched", False),
            (lambda: selection.weighted_median(x[:5000], w[:5000]),
             "wcp_partials_batched", True),
            (lambda: selection.weighted_quantiles(x, w, [0.1, 0.5, 0.9]),
             "wcp_histogram_multi", False),
            (lambda: selection.weighted_quantiles(x, w, [0.1, 0.5, 0.9],
                                                  method="cp"),
             "wcp_partials_multi", False)):
        cp_objective.reset_launches()
        res = call()
        launched = {k: v for k, v in cp_objective.LAUNCHES.items() if v}
        # each weighted pass sums its f32 block partials with sum_blocks,
        # and so does each of the masses the rows path and the finalize
        # sum per row (row_sums)
        rows = launched.pop("row_sums", 0)
        assert rows > 0
        want_launches = {key: int(res.iters.max()),
                         "sum_blocks": int(res.iters.max()) + rows}
        assert launched == want_launches, launched
        if not small:
            qs = [0.5] if res.value.dim() == 0 else [0.1, 0.5, 0.9]
            want = [oracle(float(torch.tensor(q * W, dtype=torch.float32)))
                    for q in qs]
            assert res.value.reshape(-1).tolist() == want


def test_weighted_f64_weights_take_the_plain_version(cuda):
    """An f64 w on f32 x: no kernel runs (either-f64 rule) and the sweeps
    are the plain version's 16 bins, the same SelectResult as on the CPU."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(1 << 17, generator=g)
    w = torch.randint(1, 4, (1 << 17,), generator=g).double()
    cp_objective.reset_launches()
    got = selection.weighted_median(x.to(cuda), w.to(cuda), method="binned")
    assert not any(cp_objective.LAUNCHES.values())
    want = selection.weighted_median(x, w, method="binned")
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("method", ["binned", "cp"])
def test_strided_views_reach_the_weighted_kernels(cuda, method):
    x = torch.randn((3, 1 << 17), device=cuda)
    w = torch.randint(0, 4, (3, 1 << 17), device=cuda).float()
    kernel = {"binned": "wcp_histogram_batched",
              "cp": "wcp_partials_batched"}[method]
    cp_objective.reset_launches()
    res = selection.weighted_median(x[0, ::2], w[0, ::2], method=method)
    assert cp_objective.LAUNCHES[kernel] > 0
    want = selection.weighted_median(x[0, ::2].cpu(), w[0, ::2].cpu(),
                                     method="sort")
    assert float(res.value) == float(want.value)
    wks = torch.tensor([1.0, 777.0, 3e4], device=cuda)
    res = selection.weighted_select_rows(x[:, : 1 << 16], w[:, : 1 << 16],
                                         wks, method=method)
    want = selection.weighted_select_rows(x[:, : 1 << 16].cpu(),
                                          w[:, : 1 << 16].cpu(), wks.cpu(),
                                          method="sort")
    assert torch.equal(res.value.cpu(), want.value)


# ---------------------------------------------------------------------------
# the per-slot sums legs K1s, K1ws, K3s, K3ws (want_sums, the polish input)
# ---------------------------------------------------------------------------


def _int_data(rows, n, seed, device):
    """Integer-valued x in [-50, 50) with ±inf and NaN planted: every slot
    sum of the finite values is exact in any order (totals far below
    2^24), a NaN makes its slot's sum NaN, an inf its slot's inf."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(-50, 50, (rows, n), generator=g, device=device).float()
    x[:, :4] = torch.tensor([np.inf, -np.inf, np.nan, -0.0], device=device)
    return x


def _f32_chain(n):
    """The longest chain of f32 additions a value goes through in a sums
    leg: its thread's serial sum or its warp row's steps (one element per
    thread and grid stride), a slot group (32), a warp shuffle (5), the
    warps of a block (8), and the sum over the block partials."""
    nblk = cp_objective.fg_blocks(n)
    return -(-n // (nblk * 256)) + 32 + 5 + 8 + nblk


def _sums_case(leg, x, w, edges):
    """``(kernel outputs, plain outputs)`` of one sums leg; ``x`` (B, n)
    for the row legs, (n,) for the shared-x legs."""
    if leg == "K1s":
        return (cp_objective.cp_histogram_batched(x, edges, want_sums=True),
                ref.cp_histogram_batched_ref(x, edges, want_sums=True))
    if leg == "K1ws":
        return (cp_objective.wcp_histogram_batched(x, w, edges,
                                                   want_sums=True),
                ref.wcp_histogram_batched_ref(x, w, edges, want_sums=True))
    if leg == "K3s":
        return (cp_objective.cp_histogram_multi(x, edges, want_sums=True),
                ref.cp_histogram_multi_ref(x, edges, want_sums=True))
    return (cp_objective.wcp_histogram_multi(x, w, edges, want_sums=True),
            ref.wcp_histogram_multi_ref(x, w, edges, want_sums=True))


def _k1_edges(rows, device):
    lo = torch.tensor([-3e38, -2.0, 0.25, -1e-40, -1e-3, 0.0, -60.0][:rows],
                      device=device)
    hi = torch.tensor([3e38, 2.0, float(np.nextafter(np.float32(0.25),
                                                     np.float32(1))),
                       1e-40, 2e-3, 0.0, 60.0][:rows], device=device)
    return ref.bin_edges(lo, hi, 128).contiguous()


SUMS_SHAPES = [("K1", (1, 100_003), 128), ("K1", (7, 5000), 128),
               ("K3", 1, 128), ("K3", 16, 128), ("K3", 64, 128),
               ("K3", 3, 8192)]


def _sums_inputs(kind, shape, nbins, xdt, wdt, seed, device, integer):
    if kind == "K1":
        rows, n = shape
        x = (_int_data(rows, n, seed, device) if integer
             else torch.randn((rows, n), device=device))
        edges = _k1_edges(rows, device)
        if not integer:  # data-scale ladders on randn rows
            edges = ref.bin_edges(x.amin(1), x.amax(1), nbins).contiguous()
    else:
        n = 100_003
        x = (_int_data(1, n, seed, device)[0] if integer
             else torch.randn(n, device=device))
        edges = _ladders(shape, device, nbins)
        if integer:  # and a ladder at the integer data's scale
            edges[0] = ref.bin_edges(torch.tensor(-60.0, device=device),
                                     torch.tensor(60.0, device=device),
                                     nbins)
    w = torch.randint(0, 4, x.shape, device=device).float()
    return x.to(xdt), w.to(wdt), edges


# (leg, x dtype, w dtype, shape): the counting sums legs read no w
SUMS_CASES = [(leg, xdt, wdt, (kind, shape, nbins))
              for kind, shape, nbins in SUMS_SHAPES
              for leg in (f"{kind}s", f"{kind}ws")
              for xdt, wdt in (WDTYPES if leg.endswith("ws")
                               else WDTYPES[:2])]


@pytest.mark.parametrize("leg,xdt,wdt,case", SUMS_CASES)
def test_sums_legs_equal_plain_on_integers(cuda, leg, xdt, wdt, case):
    """Integer x and w: counts, masses and sums bit for bit (NaN and ±inf
    slots equal with equal_nan)."""
    kind, shape, nbins = case
    x, w, edges = _sums_inputs(kind, shape, nbins, xdt, wdt, 7, cuda, True)
    got, want = _sums_case(leg, x, w, edges)
    assert len(got) == len(want) and got[-1] is not None
    assert torch.equal(got[0], want[0])
    for g, v in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, v, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("leg,case", [(leg, (kind, shape, nbins))
                                      for kind, shape, nbins in SUMS_SHAPES
                                      for leg in (f"{kind}s", f"{kind}ws")])
def test_sums_legs_near_f64_on_randn(cuda, leg, case):
    """randn x (dense weights): each slot sum within the chain bound of the
    f64 plain version, relative to the slot's sum of |values|; two
    launches give identical bits."""
    kind, shape, nbins = case
    x, w, edges = _sums_inputs(kind, shape, nbins, torch.float32,
                               torch.float32, 8, cuda, False)
    w = torch.rand(x.shape, device=cuda) + 0.5
    got, _ = _sums_case(leg, x, w, edges)
    again, _ = _sums_case(leg, x, w, edges)
    for a, b in zip(got, again):
        assert torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    wd = w.double() if leg.endswith("ws") else torch.ones_like(x).double()
    # the f64 plain sums of w*x, and of w*|x| (the error scale)
    plain = (ref.wcp_histogram_batched_ref if kind == "K1"
             else ref.wcp_histogram_multi_ref)
    exact = plain(x.double(), wd, edges)[2]
    scale = plain(x.double(), wd * torch.sign(x.double()), edges)[2]
    bound = _f32_chain(x.shape[-1]) * 2.0 ** -24 * scale
    assert bool(((got[-1].double() - exact).abs() <= bound).all())


def test_polish_and_warm_paths_launch_their_kernels(cuda):
    """binned_polish launches only the sums legs, one per sweep, and
    answers as the sort does; a warm median on unchanged data takes one
    plain sweep and certifies."""
    n = 1 << 18
    x = torch.randn(n, device=cuda)
    w = torch.randint(0, 2, (n,), device=cuda).float()
    qs = [0.1, 0.5, 0.9]
    for call, key in (
            (lambda m: selection.median(x, method=m),
             "cp_histogram_batched_sums"),
            (lambda m: selection.quantiles(x, qs, method=m),
             "cp_histogram_multi_sums"),
            (lambda m: selection.weighted_median(x, w, method=m),
             "wcp_histogram_batched_sums"),
            (lambda m: selection.weighted_quantiles(x, w, qs, method=m),
             "wcp_histogram_multi_sums")):
        cp_objective.reset_launches()
        res = call("binned_polish")
        launched = {k: v for k, v in cp_objective.LAUNCHES.items() if v}
        # each sums pass sums its f32 block partials with sum_blocks, and
        # so does each per-row sum of the rows path and the finalize
        rows = launched.pop("row_sums", 0)
        assert launched == {key: int(res.iters.max()),
                            "sum_blocks": int(res.iters.max()) + rows}, \
            launched
        assert torch.equal(res.value, call("sort").value)
    cold = selection.median(x)
    cp_objective.reset_launches()
    warm = selection.median(x, prior=cold)
    assert int(warm.iters) == 1 and int(warm.status) == selection.EXACT_HIT
    assert cp_objective.LAUNCHES["cp_histogram_batched"] == 1
    assert float(warm.value) == float(cold.value)


# ---------------------------------------------------------------------------
# K1 and K1w: the lane-private design (128 bins) and the wide-ladder designs
# (8192 bins); block sums that ignore the rest of the launch
# ---------------------------------------------------------------------------

K1_SHAPES = [(1, 1 << 27), (64, 1 << 20), (1, (1 << 20) + 3),
             (5, 100_003)]


def _first_sweep_edges(x, nbins):
    """Each row's [min, max] over its values below 1e30 in magnitude: the
    first sweep's ladder, every element but the planted specials inside."""
    xf = x.float()
    ok = xf.abs() < 1e30
    lo = torch.where(ok, xf, float("inf")).amin(dim=1)
    hi = torch.where(ok, xf, float("-inf")).amax(dim=1)
    return ref.bin_edges(lo, hi, nbins).contiguous()


def _wide_edges(rows, device):
    return ref.bin_edges(torch.full((rows,), -2.0, device=device),
                         torch.full((rows,), 2.0, device=device), 8192)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,n", K1_SHAPES)
def test_row_histogram_first_sweep_equals_plain(cuda, dtype, rows, n):
    """K1's lane-private design (``full_bracket``) on the first sweep
    (every element but the specials in the bracket) and on ladders cycling
    through full-range, data-scale, one-ulp, denormal and narrow brackets,
    with rows that start off a 16-byte boundary among them: counts bit for
    bit, as the shared design's, two launches identical."""
    x = _data(rows, n, 5, cuda).to(dtype)
    if rows == 5:  # rows that start off a 16-byte boundary: head elements
        buf = torch.empty(rows * n + 3, dtype=dtype, device=cuda)
        x = buf[3:].view(rows, n).copy_(x)
    for edges in (_first_sweep_edges(x, 128), _ladders(rows, cuda)):
        assert cp_objective.hist_rows_layout(edges.shape[1], 0, n,
                                             True) == "lane"
        got, _ = cp_objective.cp_histogram_batched(x, edges,
                                                   full_bracket=True)
        want, _ = ref.cp_histogram_batched_ref(x, edges, want_sums=False)
        assert torch.equal(got, want)
        assert torch.equal(got, cp_objective.cp_histogram_batched(
            x, edges, full_bracket=True)[0])
        assert torch.equal(got, cp_objective.cp_histogram_batched(x, edges)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_histogram_wide_ladder_equals_plain(cuda, dtype):
    """8192 bins: K1's shared-histogram design, opting in past 48 KB."""
    n = (1 << 20) + 3
    x = _data(3, n, 6, cuda).to(dtype)
    for edges in (_wide_edges(3, cuda), _first_sweep_edges(x, 8192)):
        assert cp_objective.hist_rows_layout(edges.shape[1], 0, n,
                                             True) == "shared"
        got, _ = cp_objective.cp_histogram_batched(x, edges,
                                                   full_bracket=True)
        want, _ = ref.cp_histogram_batched_ref(x, edges, want_sums=False)
        assert torch.equal(got, want)


@pytest.mark.parametrize("xdt,wdt", WDTYPES)
@pytest.mark.parametrize("nbins", [128, 8192])
def test_weighted_row_histogram_designs_equal_plain(cuda, xdt, wdt, nbins):
    """K1w's lane-private design (128 bins, ``full_bracket``, rows of
    LANE_ROWS_MIN_N + 3 elements) and grouped design (8192 bins) on the
    first sweep's ladder: counts and integer masses bit for bit; dense
    masses within the f32 chain of the f64 sums, two launches
    identical."""
    n = cp_objective.LANE_ROWS_MIN_N + 3
    x = _data(2, n, 7, cuda)
    edges = _first_sweep_edges(x, nbins)
    assert cp_objective.hist_rows_layout(edges.shape[1], 1, n, True) == (
        "lane" if nbins == 128 else "grouped")
    xq, w = x.to(xdt), _int_weights((2, n), 7, cuda).to(wdt)
    cnt, mass, _ = cp_objective.wcp_histogram_batched(xq, w, edges,
                                                      full_bracket=True)
    want = ref.wcp_histogram_batched_ref(xq, w, edges, want_sums=False)
    assert torch.equal(cnt, want[0]) and torch.equal(mass, want[1])
    wd = _dense_weights((2, n), 8, cuda)
    mass = cp_objective.wcp_histogram_batched(x, wd, edges,
                                              full_bracket=True)[1]
    again = cp_objective.wcp_histogram_batched(x, wd, edges,
                                               full_bracket=True)[1]
    assert torch.equal(_bits(mass), _bits(again))
    exact = ref.wcp_histogram_batched_ref(x, wd.double(), edges,
                                          want_sums=False)[1]
    bound = _f32_chain(n) * 2.0 ** -24 * exact
    assert bool(((mass.double() - exact).abs() <= bound).all())


def test_row_masses_ignore_the_other_rows(cuda):
    """K1w at 1024 block partials with dense weights, in both designs: each
    of 16 rows alone gives its entry's counts and masses bit for bit."""
    n = (1 << 23) + 3
    assert cp_objective.fg_blocks(n) == cp_objective.FG_MAX_BLOCKS
    g = torch.Generator(device=cuda).manual_seed(11)
    x = torch.randn((16, n), generator=g, device=cuda)
    w = torch.rand((16, n), generator=g, device=cuda) + 0.5
    edges = _first_sweep_edges(x, 128)
    for full in (True, False):  # the lane-private and grouped designs
        cnt, mass, _ = cp_objective.wcp_histogram_batched(
            x, w, edges, full_bracket=full)
        for r in range(16):
            c1, m1, _ = cp_objective.wcp_histogram_batched(
                x[r:r + 1], w[r:r + 1], edges[r:r + 1], full_bracket=full)
            assert torch.equal(cnt[r:r + 1], c1)
            assert torch.equal(_bits(mass[r:r + 1]), _bits(m1))


@pytest.mark.parametrize("ladders", ["first sweep", "narrow", "cycled",
                                     "staggered", "polished"])
def test_ladder_masses_ignore_the_other_ladders(cuda, ladders):
    """K3w at 1024 block partials with dense weights, on the ladders of a
    16-quantile descent (the first sweep's identical ones, the distinct
    narrow ones it picks, the polished first sweep's, every element inside
    all 16) and on nested, disjoint and partly overlapping ones: each
    ladder alone, and the 16 in another order, give their entries' counts
    and masses bit for bit, and so do the 16 with ``full_bracket`` (a first
    sweep of identical ladders bins the one ladder)."""
    n = (1 << 23) + 3
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda) + 0.5
    ks = selection.ranks_from_quantiles(np.arange(1, 17) / 17, n).to(cuda)
    e = _descent_ladders(ladders, x, ks, cuda)
    cnt, mass, _ = cp_objective.wcp_histogram_multi(x, w, e)
    # a first sweep (full_bracket) of identical ladders bins the one ladder
    cf, mf, _ = cp_objective.wcp_histogram_multi(x, w, e, full_bracket=True)
    assert torch.equal(cnt, cf) and torch.equal(_bits(mass), _bits(mf))
    for j in range(16):
        c1, m1, _ = cp_objective.wcp_histogram(x, w, e[j])
        assert torch.equal(cnt[j], c1)
        assert torch.equal(_bits(mass[j]), _bits(m1))
    perm = torch.randperm(16, generator=torch.Generator(device=cuda)
                          .manual_seed(13), device=cuda)
    cp, mp, _ = cp_objective.wcp_histogram_multi(x, w, e[perm].contiguous())
    assert torch.equal(cnt[perm], cp)
    assert torch.equal(_bits(mass[perm]), _bits(mp))


# ---------------------------------------------------------------------------
# K3s and K3ws: the sorted-tile design, whose sums follow each ladder alone
# ---------------------------------------------------------------------------


def _descent_ladders(kind, x, ks, device):
    """16 ladders of a 16-quantile descent on ``x``: the first sweep's
    identical ones over [min, max], the distinct narrow ones its descent
    step picks, the five bracket kinds cycled (overlapping), 16 staggered
    brackets each overlapping its neighbours in part, or the polished first
    sweep's (each over [min, max], half its edges around its own seed
    cut)."""
    e = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e = e.contiguous()
    if kind == "narrow":
        cnt1 = cp_objective.cp_histogram_multi(x, e)[0]
        cum = torch.cumsum(cnt1[:, :-1], dim=-1, dtype=torch.int32)
        yl, yr, *_ = selection.binned_descent_step(cum, e, e[:, 0],
                                                   e[:, -1], ks)
        e = ref.bin_edges(yl, yr, 128).contiguous()
    elif kind == "cycled":
        e = _ladders(16, device)
    elif kind == "staggered":
        lo = -2.0 + 0.25 * torch.arange(16, device=device,
                                        dtype=torch.float32)
        e = ref.bin_edges(lo, lo + 1.0, 128).contiguous()
    elif kind == "polished":
        ev = objective.SharedEvaluator(x, ks)
        s0, xmin, xmax, kk, _, xmean = selection._seed_state(ev)
        cut = selection._seed_cut(ev, kk, xmin, xmax, xmean)
        e = selection.polish_edges(s0.yL, s0.yR, cut, 128).contiguous()
    return e


@pytest.mark.parametrize("ladders", ["first sweep", "narrow", "cycled",
                                     "polished"])
def test_sums_ignore_the_other_ladders(cuda, ladders):
    """K3s, and K3ws with dense weights, at 1024 block partials: each of 16
    ladders alone, and the 16 in another order, give their entries'
    counts, sums and masses bit for bit."""
    n = (1 << 23) + 3
    g = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn(n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda) + 0.5
    ks = selection.ranks_from_quantiles(np.arange(1, 17) / 17, n).to(cuda)
    e = _descent_ladders(ladders, x, ks, cuda)
    perm = torch.randperm(16, generator=torch.Generator(device=cuda)
                          .manual_seed(16), device=cuda)
    for multi, one in (
            (lambda ee: cp_objective.cp_histogram_multi(x, ee,
                                                        want_sums=True),
             lambda e1: cp_objective.cp_histogram(x, e1, want_sums=True)),
            (lambda ee: cp_objective.wcp_histogram_multi(x, w, ee,
                                                         want_sums=True),
             lambda e1: cp_objective.wcp_histogram(x, w, e1,
                                                   want_sums=True))):
        got = multi(e)
        for j in range(16):
            for a, b in zip(got, one(e[j])):
                assert torch.equal(_bits(a[j]), _bits(b))
        for a, b in zip(got, multi(e[perm].contiguous())):
            assert torch.equal(_bits(a[perm]), _bits(b))


@pytest.mark.parametrize("nedges", [129, 8193])
@pytest.mark.parametrize("design", ["sorted", "grouped"])
def test_sums_designs_equal_plain(cuda, nedges, design):
    """Both designs of K3s/K3ws at a narrow and a wide ladder: counts, sums
    and masses bit for bit on integer data."""
    x = _int_data(1, 100_003, 17, cuda)[0]
    w = torch.randint(0, 4, x.shape, device=cuda).float()
    e = ref.bin_edges(torch.tensor([-60.0, -2.0, 0.0], device=cuda),
                      torch.tensor([60.0, 2.0, 30.0], device=cuda),
                      nedges - 1).contiguous()
    for got, want in (
            (cp_objective._whist_multi(x, None, e, "cp_histogram_multi_sums",
                                       True, design=design),
             ref.cp_histogram_multi_ref(x, e, want_sums=True)),
            (cp_objective._whist_multi(x, w, e, "wcp_histogram_multi_sums",
                                       True, design=design),
             ref.wcp_histogram_multi_ref(x, w, e, want_sums=True))):
        assert torch.equal(got[0], want[0])
        for a, b in zip(got[1].unbind(1), want[1:]):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("nedges,weighted", [(767, False), (604, True)])
def test_sorted_sums_at_the_shared_memory_edge(cuda, nedges, weighted):
    """K3s at 767 edges and K3ws at 604, 16 ladders: the widths at which 16
    ladders a block fit the dynamic shared bytes alone but not with the
    kernel's static arrays; the launch takes 8 a block and equals the plain
    versions bit for bit on integer data."""
    nrows = 2 if weighted else 1
    assert cp_objective.sorted_sums_group(16, nedges, nrows) == 8
    x = _int_data(1, 100_003, 18, cuda)[0]
    w = torch.randint(0, 4, x.shape, device=cuda).float() if weighted \
        else None
    lo = -60.0 + torch.arange(16, device=cuda, dtype=torch.float32)
    e = ref.bin_edges(lo, lo + 100.0, nedges - 1).contiguous()
    if weighted:
        got = cp_objective._whist_multi(x, w, e, "wcp_histogram_multi_sums",
                                        True, design="sorted")
        want = ref.wcp_histogram_multi_ref(x, w, e, want_sums=True)
    else:
        got = cp_objective._whist_multi(x, None, e,
                                        "cp_histogram_multi_sums", True,
                                        design="sorted")
        want = ref.cp_histogram_multi_ref(x, e, want_sums=True)
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1].unbind(1), want[1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------------------
# K3's two designs, the grouped sums legs' company, and the rows path's sums
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ladders", ["first sweep", "staggered", "cycled"])
def test_k3_designs_equal_plain(cuda, dtype, ladders):
    """K3 with and without ``full_bracket`` (on a first sweep's identical
    ladders K1's lane kernel bins the one ladder): counts bit for bit."""
    x = _data(1, 1 << 20, 19, cuda)[0].to(dtype)
    ks = selection.ranks_from_quantiles(np.arange(1, 17) / 17, x.numel())
    e = _descent_ladders(ladders, x.float(), ks.to(cuda), cuda)
    want, _ = ref.cp_histogram_multi_ref(x, e, want_sums=False)
    for full in (False, True):
        got, _ = cp_objective.cp_histogram_multi(x, e, full_bracket=full)
        assert torch.equal(got, want)


@pytest.mark.parametrize("ladders", ["staggered", "polished"])
def test_grouped_sums_ignore_the_other_ladders(cuda, ladders):
    """K3s and K3ws in the grouped design (``hist_multi.cu``, the wide
    ladders' kernel) with dense weights: each ladder alone gives its
    entry's counts, sums and masses bit for bit."""
    n = (1 << 22) + 3
    g = torch.Generator(device=cuda).manual_seed(20)
    x = torch.randn(n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda) + 0.5
    ks = selection.ranks_from_quantiles(np.arange(1, 17) / 17, n).to(cuda)
    e = _descent_ladders(ladders, x, ks, cuda)
    for key, ww in (("cp_histogram_multi_sums", None),
                    ("wcp_histogram_multi_sums", w)):
        got = cp_objective._whist_multi(x, ww, e, key, True,
                                        design="grouped")
        for j in range(16):
            one = cp_objective._whist_multi(x, ww, e[j:j + 1], key, True,
                                            design="grouped")
            for a, b in zip(got, one):
                assert torch.equal(_bits(a[j]), _bits(b[0]))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_row_sums_equal_plain_and_ignore_the_batch(cuda, xdt, wdt):
    """``row_sums``: with integer weights the masses (all, at or below and
    below a per-row value) equal the plain version bit for bit; with dense
    weights every mode stays near the f64 sums, and each row alone gets
    its entry's bits."""
    x = _data(9, 300_001, 21, cuda)
    g = torch.Generator(device=cuda).manual_seed(22)
    wi = torch.randint(0, 8, x.shape, generator=g, device=cuda).float()
    c = x[:, 777].contiguous()
    xt, wt = x.to(xdt), wi.to(wdt)
    for mode in ("mass", "le", "lt"):
        got = cp_objective.row_sums(xt, wt, c, mode)
        want = ref.row_sums_ref(xt, wt, c, mode, dtype=torch.float32)
        assert torch.equal(got, want)
    xd = torch.randn((9, 300_001), generator=g, device=cuda)
    wd = torch.rand((9, 300_001), generator=g, device=cuda) + 0.5
    for w, mode in ((None, "mass"), (wd, "mass"), (wd, "moment"),
                    (wd, "le"), (wd, "lt")):
        got = cp_objective.row_sums(xd, w, c, mode)
        exact = ref.row_sums_ref(xd.double(), None if w is None else
                                 w.double(), c.double(), mode,
                                 dtype=torch.float64)
        torch.testing.assert_close(got.double(), exact, rtol=1e-5,
                                   atol=1e-5 * float(exact.abs().max()))
        for r in range(9):
            one = cp_objective.row_sums(xd[r:r + 1], None if w is None
                                        else w[r:r + 1], c[r:r + 1], mode)
            assert torch.equal(_bits(one), _bits(got[r:r + 1]))


@pytest.mark.parametrize("leg", ["weighted dense", "counting cp",
                                 "weighted dense polish"])
def test_rows_answers_ignore_the_batch(cuda, leg):
    """Every SelectResult field of a row alone, and of the rows permuted,
    equals its entry in the batch, bit for bit: with dense weights ('binned'
    and 'binned_polish', whose first sweep runs K1ws), and on the counting
    leg's cp method, whose first pivot follows the row's mean."""
    g = torch.Generator(device=cuda).manual_seed(23)
    x = torch.randn((16, 1 << 18), generator=g, device=cuda)
    w = torch.rand((16, 1 << 18), generator=g, device=cuda) + 0.5
    wks = torch.rand(16, generator=g, device=cuda) * w.sum(dim=1)
    ks = torch.randint(1, (1 << 18) + 1, (16,), generator=g, device=cuda)
    if leg.startswith("weighted dense"):
        method = "binned_polish" if leg.endswith("polish") else None

        def run(r):
            return selection.weighted_select_rows(x[r], w[r], wks[r],
                                                  method=method)
    else:
        def run(r):
            return selection.select_rows(x[r], ks[r], method="cp")
    every = torch.arange(16, device=cuda)
    batch = run(every)
    perm = torch.randperm(16, generator=g, device=cuda)
    for a, b in zip(run(perm), batch):
        assert torch.equal(_bits(a), _bits(b[perm]))
    for r in range(16):
        for a, b in zip(run(every[r:r + 1]), batch):
            assert torch.equal(_bits(a), _bits(b[r:r + 1]))


# ---------------------------------------------------------------------------
# K1s and K1ws: the lane-column design on first sweeps (bucket lookup)
# ---------------------------------------------------------------------------


def _rows_ladders(x, w, device):
    """The first-sweep ladders of K1s (K1ws with ``w``) on ``x`` (B, n):
    the engine's polished one (``polish_edges`` around each row's seed
    cut), the uniform one over each row's finite range, and a warm tick's
    ``prior_edges`` one (from a cold answer on the same rows), all made
    from ``x`` with its non-finite values set to 0."""
    x = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    rows, n = x.shape
    k = (torch.full((rows,), (n + 1) // 2, device=device) if w is None
         else 0.5 * w.sum(dim=1))
    ev = objective.RowsEvaluator(x, k, **({} if w is None
                                          else {"weights": w}))
    s0, xmin, xmax, kk, _, xmean = selection._seed_state(ev)
    cut = selection._seed_cut(ev, kk, xmin, xmax, xmean)
    bad = ~torch.isfinite(cut) | (cut <= s0.yL) | (cut >= s0.yR)
    tp = torch.where(bad, 0.5 * (s0.yL + s0.yR), cut)
    cold = selection.select_rows(x, torch.full((rows,), (n + 1) // 2,
                                               device=device))
    pb = selection._prior_to(selection.as_prior(cold), torch.float32, s0.yL)
    return {"polished": selection.polish_edges(s0.yL, s0.yR, tp,
                                               128).contiguous(),
            "uniform": _first_sweep_edges(x, 128),
            "prior": selection.prior_edges(s0.yL, s0.yR, pb,
                                           128).contiguous()}


def _sums_call(leg, x, w, edges, design):
    key = ("cp" if leg == "K1s" else "wcp") + "_histogram_batched_sums"
    return cp_objective._hist_rows(x, None if leg == "K1s" else w, edges,
                                   True, key, True, design=design)


def _sums_plain(leg, x, w, edges):
    if leg == "K1s":
        cnt, s = ref.cp_histogram_batched_ref(x, edges, want_sums=True)
        return cnt, s[:, None]
    cnt, m, s = ref.wcp_histogram_batched_ref(x, w, edges, want_sums=True)
    return cnt, torch.stack([m, s], dim=1)


@pytest.mark.parametrize("leg", ["K1s", "K1ws"])
@pytest.mark.parametrize("xdt,wdt", WDTYPES)
def test_lane_sums_equal_plain_on_integers(cuda, leg, xdt, wdt):
    """K1s and K1ws in the lane-column design, on integer data with ±inf,
    NaN and ±0 at an odd n, against polished, uniform and prior ladders
    (and the engine's layout picks it there): counts, masses and sums bit
    for bit, as the grouped design's; at 8192 bins the grouped design,
    bit for bit too."""
    if leg == "K1s" and wdt != torch.float32:
        pytest.skip("K1s reads no w")
    n = cp_objective.LANE_SUMS_MIN_N + 3
    g = torch.Generator(device=cuda).manual_seed(31)
    # -4..4 at density 1/16 (a slot's sum of |w*x| stays below 2^24)
    x = (torch.randint(-4, 5, (2, n), generator=g, device=cuda).float()
         * (torch.rand((2, n), generator=g, device=cuda) < 1 / 16))
    x[:, :5] = torch.tensor([np.inf, -np.inf, np.nan, -0.0, 0.0],
                            device=cuda)
    w = _int_weights((2, n), 32, cuda)
    nrows = 1 if leg == "K1s" else 2
    for label, edges in _rows_ladders(x, w if leg == "K1ws" else None,
                                      cuda).items():
        assert cp_objective.hist_rows_layout(129, nrows, n, True,
                                             sums=True) == "lane_sums"
        xq, wq = x.to(xdt), w.to(wdt)
        want = _sums_plain(leg, xq, wq, edges)
        for design in cp_objective.ROWS_SUMS_DESIGNS:
            cnt, rows = _sums_call(leg, xq, wq, edges, design)
            assert torch.equal(cnt, want[0]), (label, design)
            torch.testing.assert_close(rows, want[1], rtol=0, atol=0,
                                       equal_nan=True)
    wide = _first_sweep_edges(x, 8192)
    assert cp_objective.hist_rows_layout(8193, nrows, n, True,
                                         sums=True) == "grouped"
    got = (cp_objective.cp_histogram_batched(x, wide, want_sums=True,
                                             full_bracket=True)
           if leg == "K1s" else
           cp_objective.wcp_histogram_batched(x, w, wide, want_sums=True,
                                              full_bracket=True))
    want = _sums_plain(leg, x, w, wide)
    assert torch.equal(got[0], want[0])
    torch.testing.assert_close(torch.stack(got[1:], dim=1), want[1],
                               rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("leg", ["K1s", "K1ws"])
def test_lane_sums_ignore_the_batch_and_the_alignment(cuda, leg):
    """K1s and K1ws in the lane-column design at 1024 block partials (an
    odd n) with dense weights: each of 16 rows alone, the 16 permuted, and
    a row read from an address off its 16-byte boundary give their
    entries' counts and f32 rows bit for bit; two launches identical;
    randn sums within the f32 chain of the f64 sums."""
    n = (1 << 23) + 3
    g = torch.Generator(device=cuda).manual_seed(33)
    x = torch.randn((16, n), generator=g, device=cuda)
    w = torch.rand((16, n), generator=g, device=cuda) + 0.5
    edges = _rows_ladders(x, w if leg == "K1ws" else None,
                          cuda)["polished"]
    cnt, rows = _sums_call(leg, x, w, edges, "lane_sums")
    again = _sums_call(leg, x, w, edges, "lane_sums")
    assert torch.equal(cnt, again[0])
    assert torch.equal(_bits(rows), _bits(again[1]))
    perm = torch.randperm(16, generator=g, device=cuda)
    cp, rp = _sums_call(leg, x[perm].contiguous(), w[perm].contiguous(),
                        edges[perm].contiguous(), "lane_sums")
    assert torch.equal(cnt[perm], cp)
    assert torch.equal(_bits(rows[perm]), _bits(rp))
    for r in range(16):
        c1, r1 = _sums_call(leg, x[r:r + 1], w[r:r + 1], edges[r:r + 1],
                            "lane_sums")
        assert torch.equal(cnt[r:r + 1], c1)
        assert torch.equal(_bits(rows[r:r + 1]), _bits(r1))
    for off in (1, 3):  # row 0 starting 4 or 12 bytes past a boundary
        xb = torch.empty(n + off, device=cuda)[off:].view(1, n)
        wb = torch.empty(n + off, device=cuda)[off:].view(1, n)
        xb.copy_(x[:1])
        wb.copy_(w[:1])
        c1, r1 = _sums_call(leg, xb, wb, edges[:1], "lane_sums")
        assert torch.equal(cnt[:1], c1)
        assert torch.equal(_bits(rows[:1]), _bits(r1))
    wd = w.double() if leg == "K1ws" else torch.ones_like(x).double()
    exact = ref.wcp_histogram_batched_ref(x.double(), wd, edges)[2]
    scale = ref.wcp_histogram_batched_ref(x.double(),
                                          wd * torch.sign(x.double()),
                                          edges)[2]
    bound = _f32_chain(n) * 2.0 ** -24 * scale
    assert bool(((rows[:, -1].double() - exact).abs() <= bound).all())


@pytest.mark.parametrize("method", ["binned", "binned_polish", "cp"])
def test_segmented_on_the_card(cuda, method):
    """Segmented selection is plain torch on the card: no kernel launches;
    two runs give the same bits; each of 16 interleaved segments solved
    alone (the same cap) equals its entry among the 16 in every field;
    values against a per-segment sort; and the per-segment group sums
    (``GroupPlan``) are the CPU's bits."""
    n = (1 << 20) + 3 if method != "cp" else 50_000
    g = torch.Generator(device=cuda).manual_seed(41)
    x = torch.randn(n, generator=g, device=cuda) * 3.0
    seg = torch.randint(0, 16, (n,), generator=g, device=cuda,
                        dtype=torch.int32)
    sizes = torch.bincount(seg, minlength=16)
    ks = (torch.rand(16, generator=g, device=cuda) * sizes).to(
        torch.int32) + 1
    kw = dict(method=method, cap=selection._default_cap_rows(n))
    cp_objective.reset_launches()
    a = selection.segmented_order_statistic(x, seg, ks, nsegs=16, **kw)
    assert not any(cp_objective.LAUNCHES.values()), cp_objective.LAUNCHES
    b = selection.segmented_order_statistic(x, seg, ks, nsegs=16, **kw)
    for name in a._fields:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    for i in range(16):
        xi = x[seg == i]
        alone = selection.segmented_order_statistic(
            xi, torch.zeros_like(xi, dtype=torch.int32), ks[i:i + 1],
            nsegs=1, **kw)
        for name in a._fields:
            assert torch.equal(getattr(alone, name),
                               getattr(a, name)[i:i + 1]), (i, name)
        assert float(a.value[i]) == float(torch.sort(xi).values[ks[i] - 1])
    ss, order = torch.sort(seg, stable=True)
    plan = ref.GroupPlan(ss, 16)
    sums = plan.reduce(x[order])
    cpu = ref.GroupPlan(ss.cpu(), 16).reduce(x[order].cpu())
    assert torch.equal(sums.cpu().view(torch.int32), cpu.view(torch.int32))


_SHARDED_RANK = r"""
import datetime, json, sys
import numpy as np, torch, torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
rank, world = int(sys.argv[1]), int(sys.argv[2])
init, what = sys.argv[3], sys.argv[4]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank,
                        world_size=world,
                        timeout=datetime.timedelta(seconds=60))
from repro_torch.core import distributed, selection
from repro_torch.kernels import cp_objective
mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
x = torch.from_numpy(np.random.default_rng(5).standard_normal(1 << 22)
                     .astype(np.float32)).cuda()
xl = x.chunk(world)[rank].contiguous()
qs = [i / 17 for i in range(1, 17)]
cp_objective.reset_launches()
if what == "median":
    res = distributed.sharded_median(xl, mesh, "data")
else:
    res = distributed.sharded_quantiles(xl, qs, mesh, "data")
torch.cuda.synchronize()
launches = {k: v for k, v in cp_objective.LAUNCHES.items() if v}
if what == "median":
    one = selection.median(x)
    ks = torch.tensor([(x.numel() + 1) // 2])
else:
    one = selection.quantiles(x, qs)
    ks = selection.ranks_from_quantiles(qs, x.numel())
want = torch.sort(x).values[(ks - 1).long().cuda()]
print(json.dumps({"value": res.value.reshape(-1).tolist(),
                  "iters": res.iters.reshape(-1).tolist(),
                  "status": res.status.reshape(-1).tolist(),
                  "one": one.value.reshape(-1).tolist(),
                  "want": want.tolist(), "launches": launches}))
dist.destroy_process_group()
"""


@pytest.mark.parametrize("what,kernel", [("median", "cp_histogram"),
                                         ("quantiles", "cp_histogram_multi")])
def test_sharded_two_ranks_on_the_card(cuda, tmp_path, what, kernel):
    """Two gloo ranks on the one card (each shard a CUDA tensor): the
    sharded median and 16 quantiles of 2^22 f32 equal the local engine on
    the whole array and ``torch.sort``, every rank the same answer, and
    each rank's binned rounds launch the K = 1 (median) or K = 16
    (quantiles) view of K3 and nothing else."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.kernels import _build

    _build.build_all()  # once, before the ranks start
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _SHARDED_RANK, str(r), "2",
         str(tmp_path / "init"), what], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert outs[0] == outs[1]
    r = outs[0]
    assert r["value"] == r["one"] == r["want"]
    assert 3 not in r["status"] and min(r["iters"]) >= 1
    assert set(r["launches"]) == {kernel}, r["launches"]
    assert r["launches"][kernel] == max(r["iters"])


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma2-2b"])
def test_reduced_decoder_served_on_the_card(cuda, arch):
    """A 2-layer reduced decoder (phi3-mini; gemma2: a ring-cache layer and
    softcaps) on the card against the port on the CPU on the same weights:
    16 greedy serve steps, each side feeding back its own tokens, give the
    same tokens (every CPU top-2 margin above twice the tolerance) and
    logits within 4e-6 of their largest magnitude (f32, no TF32); the
    launcher's latency percentiles equal ``torch.sort``'s values, launch
    no histogram kernel, and K2 once per cp pass (none: the 29 latencies
    fit the cap, as in the reference)."""
    import copy

    from repro_torch.configs import get_config, local_plan
    from repro_torch.launch import serve as launch
    from repro_torch.models import model
    from repro_torch.train import make_serve_step

    tol = 4e-6
    cfg = get_config(arch).reduced(n_layers=2)
    cpu = model.init(7, cfg, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    step = make_serve_step(cfg, local_plan())
    caches = [model.init_cache(cfg, 4, 16, local_plan(), dtype=torch.float32,
                               device=d) for d in ("cpu", cuda)]
    tok = [torch.zeros((4, 1), dtype=torch.int32, device=d)
           for d in ("cpu", cuda)]
    for t in range(16):
        nxt_c, lg_c, caches[0] = step(cpu, caches[0], tok[0], t)
        nxt_g, lg_g, caches[1] = step(card, caches[1], tok[1], t)
        scale = max(1.0, lg_c.abs().max().item())
        assert (lg_g.cpu() - lg_c).abs().max().item() <= tol * scale
        top2 = lg_c[:, -1].topk(2).values
        assert (top2[:, 0] - top2[:, 1]).min().item() > 2 * tol * scale
        assert torch.equal(nxt_g.cpu(), nxt_c)
        tok = [nxt_c, nxt_g]

    cp_objective.reset_launches()
    res = launch.serve(cfg, 4, 16, 16, params=card, device=cuda)
    launches = {k: n for k, n in cp_objective.LAUNCHES.items() if n}
    assert set(launches) <= {"cp_partials_batched", "sum_blocks",
                             "row_sums"}, launches
    passes = int(res.p50.iters) + int(res.p99.iters)
    assert launches.get("cp_partials_batched", 0) == passes, launches
    srt = torch.sort(res.latencies).values
    n = srt.numel()
    assert res.p50.value.item() == srt[(n + 1) // 2 - 1].item()
    assert res.p99.value.item() == srt[math.ceil(0.99 * n) - 1].item()
    assert 3 not in (int(res.p50.status), int(res.p99.status))


def test_reduced_train_step_on_the_card(cuda):
    """Two reduced phi3-mini train steps (AdamW, the quantile clip) on the
    card against the port on the CPU from the same weights and batches:
    losses within 1e-5 relative, ``clip_thr`` within 1e-3 relative (12
    cutting-plane passes over sums in another order), every parameter
    within 0.05 lr a step of the CPU's and all but 2% within 1e-4 lr
    (Adam's m / (sqrt(v) + eps) magnifies gradients near eps), as
    tests/test_torch_train.py holds the port against the reference; the
    clip's selections run on the card (f32 matmuls without TF32)."""
    import copy

    from repro_torch.configs import get_config, local_plan
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import batch_for_shape
    from repro_torch.models import model
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, make_train_step

    assert torch.get_float32_matmul_precision() == "highest"
    lr = 1e-2
    cfg = get_config("phi3-mini-3.8b").reduced()
    shape = ShapeConfig("t", 24, 2, "train")
    states, metrics = [], []
    cpu = model.init(5, cfg, device="cpu")
    for params in (cpu, copy.deepcopy(cpu).to(cuda)):
        opt = AdamW(lr=lr)
        state = TrainState(params, opt.init(params), 0)
        step = make_train_step(cfg, local_plan(), opt, clip="quantile")
        out = []
        for i in range(2):
            state, m = step(state, batch_for_shape(cfg, shape, seed=1,
                                                   step=i))
            out.append({k: float(v) for k, v in m.items()})
        states.append(state)
        metrics.append(out)
    for mc, mg in zip(*metrics):
        assert abs(mg["loss"] - mc["loss"]) <= 1e-5 * abs(mc["loss"])
        assert abs(mg["clip_thr"] - mc["clip_thr"]) <= 1e-3 * mc["clip_thr"]
    far = total = 0
    for (n, pc), (_, pg) in zip(states[0].params.named_parameters(),
                                states[1].params.named_parameters()):
        d = (pg.detach().cpu() - pc.detach()).abs()
        assert d.max().item() <= 0.05 * lr * 2, n
        far += int((d > 1e-4 * lr).sum())
        total += d.numel()
    assert far <= 0.02 * total
