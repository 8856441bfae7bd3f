"""The rows path's f32 sums, held to "a row's answer does not follow its
batch" on the CPU.

``select_rows`` and ``weighted_select_rows`` sum each row of a (B, n)
block: the total mass W and the weighted mean (``RowsEvaluator``), the
counting mean (``objective.compiled_mean``), and the finalize's masses at
or below y_L and vnext and below the maximum (``_compact_interval``,
``_finalize_rows``).  A ``torch.sum(..., dim=1)`` over the whole block
splits its work by the block's shape and torch's threads, so at several
threads a row's sum could differ in its last bits alone and in a batch,
and so its answer's fields.  These sums now go through
``kernels.ops.row_sums`` (row by row here, the fixed-order kernel of
``csrc/sum_blocks.cu`` on the card; ``tests/test_torch_cuda.py`` holds it
there).  Checked here, at several threads (two for the engine runs, six
for the sums alone):

* every ``SelectResult`` field of a row alone (every eighth row) equals
  its entry among 64 rows, and the 64 permuted their entries, on the
  counting leg (cp, binned polish) and with dense weights (cp, binned);
* ``row_sums_ref`` of one row is the bits of the ``torch.sum(..., dim=1)``
  it replaced, for every mode and dtype (the B = 1 paths did not move);
* with integer weights the rows path equals the JAX reference bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import selection as jsel  # noqa: E402
from repro_torch.convert import from_numpy, select_result_from_numpy  # noqa: E402,E501
from repro_torch.core import selection as tsel  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per test process (restored after the module);
    the tests that need several threads set them inside."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _threads(count):
    """``count`` intra-op threads, where torch.sum over a (B, n) block
    splits its rows' additions by the block's shape (restored after)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(count)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def six_threads():
    yield from _threads(6)


@pytest.fixture
def two_threads():
    """Two threads for the engine runs: they already split the batch's
    sums, and six threads in each of the suite's worker processes
    oversubscribe the cores, which slowed this file's many small parallel
    regions some thirtyfold."""
    yield from _threads(2)


ROWS, N = 64, 1 << 16
# the rows run alone: every eighth (each alone run pays torch's six-thread
# dispatch on every small op)
ALONE = range(0, ROWS, 8)
FIELDS = ("value", "iters", "status", "y_lo", "y_hi", "n_in")


def _t(a):
    return from_numpy(np.ascontiguousarray(a), device="cpu")


def _bits(t):
    a = t.numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(a, b, label):
    for name in FIELDS:
        np.testing.assert_array_equal(_bits(getattr(a, name)),
                                      _bits(getattr(b, name)),
                                      err_msg=f"{label}: {name}")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, N), dtype=np.float32)
    w = (rng.random((ROWS, N), dtype=np.float32) + 0.5).astype(np.float32)
    ks = rng.integers(1, N + 1, ROWS).astype(np.int32)
    wks = (rng.uniform(0.05, 0.95, ROWS) * w.sum(axis=1, dtype=np.float64)
           ).astype(np.float32)
    return x, w, ks, wks


@pytest.mark.parametrize("leg,method", [("counting", "cp"),
                                        ("counting", "binned_polish"),
                                        ("dense", "cp"),
                                        ("dense", "binned")])
def test_row_alone_equals_batch_entry(leg, method, two_threads):
    x, w, ks, wks = _inputs(7)
    if leg == "counting":
        def run(rows):
            return tsel.select_rows(_t(x[rows]), _t(ks[rows]), method=method)
    else:
        def run(rows):
            return tsel.weighted_select_rows(_t(x[rows]), _t(w[rows]),
                                             _t(wks[rows]), method=method)
    batch = run(np.arange(ROWS))
    assert not bool((batch.status == tsel.NOT_CONVERGED).any())
    perm = np.random.default_rng(8).permutation(ROWS)
    permuted = run(perm)
    inv = torch.from_numpy(np.argsort(perm))
    _same(type(batch)(*(f[inv] for f in permuted)), batch,
          f"{leg} {method}: the 64 rows permuted")
    for r in ALONE:
        _same(run(np.array([r])), type(batch)(*(f[r:r + 1] for f in batch)),
              f"{leg} {method}: row {r} alone")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float64])
@pytest.mark.parametrize("mode", [None, "mass", "moment", "le", "lt"])
def test_one_row_sum_is_the_replaced_sum(mode, dtype, six_threads):
    """``row_sums_ref`` on one row gives the bits of the reduction it
    replaced (``torch.sum(..., dim=1)`` over (1, n)), and each row of a
    batch the bits of the row alone."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 70_001))).to(dtype)
    w = torch.from_numpy(rng.random((5, 70_001)) + 0.5).to(dtype)
    c = torch.tensor([0.1, -0.3, 2.0, float("inf"), -float("inf")],
                     dtype=torch.float64).to(
        torch.promote_types(dtype, torch.float32))
    acc = torch.promote_types(dtype, torch.float32)
    zero = torch.zeros((), dtype=dtype)
    replaced = {None: x, "mass": w, "moment": w * x,
                "le": torch.where(x <= c[:, None], w, zero),
                "lt": torch.where(x < c[:, None], w, 0)}[mode]
    got = tref.row_sums_ref(x, None if mode is None else w, c, mode or "mass",
                            dtype=acc)
    for r in range(5):
        want = torch.sum(replaced[r:r + 1], dim=1, dtype=acc)
        np.testing.assert_array_equal(got[r:r + 1].numpy(), want.numpy())
        alone = tref.row_sums_ref(x[r:r + 1], None if mode is None else
                                  w[r:r + 1], c[r:r + 1], mode or "mass",
                                  dtype=acc)
        np.testing.assert_array_equal(alone.numpy(), got[r:r + 1].numpy())


def test_integer_weights_match_reference(two_threads):
    """Exactly summable weights: every field equals the reference's."""
    rng = np.random.default_rng(11)
    b, n = 16, 1 << 16
    x = rng.integers(-1000, 1000, (b, n)).astype(np.float32)
    w = rng.integers(0, 5, (b, n)).astype(np.float32)
    w[:, 0] = 1.0
    wks = (rng.uniform(0.05, 1.0, b) * w.sum(axis=1)).astype(np.float32)
    got = tsel.weighted_select_rows(_t(x), _t(w), _t(wks), method="binned")
    ref = jsel.weighted_select_rows(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(wks), method="binned",
                                    backend="jnp")
    want = select_result_from_numpy(
        type(ref)(*(np.asarray(f) for f in ref)), device="cpu")
    _same(got, want, "integer weights against the reference")
