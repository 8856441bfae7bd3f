"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips (inside the ``cuda`` fixture) where
``torch.cuda.is_available()`` is false.  On a GPU machine run
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``;
the first test builds the kernels with nvcc.  No JAX needed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import selection  # noqa: E402
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
        # each weighted pass sums its f32 block partials with sum_blocks
        want_launches = {key: int(res.iters.max()),
                         "sum_blocks": int(res.iters.max())}
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
        # each sums pass sums its f32 block partials with sum_blocks
        assert launched == {key: int(res.iters.max()),
                            "sum_blocks": int(res.iters.max())}, launched
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


@pytest.mark.parametrize("ladders", ["first sweep", "narrow"])
def test_ladder_masses_ignore_the_other_ladders(cuda, ladders):
    """K3w at 1024 block partials with dense weights, on the ladders of a
    16-quantile descent (the first sweep's identical ones, then the
    distinct narrow ones it picks): each ladder alone, and the 16 in
    another order, give their entries' counts and masses bit for bit."""
    n = (1 << 23) + 3
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(n, generator=g, device=cuda)
    w = torch.rand(n, generator=g, device=cuda) + 0.5
    e = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e = e.contiguous()
    if ladders == "narrow":
        ks = selection.ranks_from_quantiles(np.arange(1, 17) / 17, n)
        cnt1 = cp_objective.cp_histogram_multi(x, e)[0]
        cum = torch.cumsum(cnt1[:, :-1], dim=-1, dtype=torch.int32)
        yl, yr, *_ = selection.binned_descent_step(
            cum, e, e[:, 0], e[:, -1], ks.to(cuda))
        e = ref.bin_edges(yl, yr, 128).contiguous()
    cnt, mass, _ = cp_objective.wcp_histogram_multi(x, w, e)
    for j in range(16):
        c1, m1, _ = cp_objective.wcp_histogram(x, w, e[j])
        assert torch.equal(cnt[j], c1)
        assert torch.equal(_bits(mass[j]), _bits(m1))
    perm = torch.randperm(16, generator=torch.Generator(device=cuda)
                          .manual_seed(13), device=cuda)
    cp, mp, _ = cp_objective.wcp_histogram_multi(x, w, e[perm].contiguous())
    assert torch.equal(cnt[perm], cp)
    assert torch.equal(_bits(mass[perm]), _bits(mp))
