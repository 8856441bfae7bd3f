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
