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
