"""CUDA kernels of the selection engine's data passes, and their wrappers.

Four hand-written kernels for Hopper (``sm_90a``), built from ``csrc/`` by
:mod:`repro_torch.kernels._build` at first use, each with a counting leg
and a weighted leg (a static specialization of the same source):

* K1 ``csrc/hist_batched.cu`` behind :func:`cp_histogram_batched` and, on
  the weighted leg, :func:`wcp_histogram_batched` (K1w) — the row-wise
  binned sweep (replaces the TPU body ``_hist_kernel_batched`` of
  ``repro/kernels/cp_objective.py``); with ``want_sums`` the same wrappers
  launch the legs that also sum the values per slot, K1s (Σx) and K1ws
  (Σw·x), the input of the polish;
* K2 ``csrc/fg_batched.cu`` behind :func:`cp_partials_batched` and
  :func:`wcp_partials_batched` (K2w) — the row-wise cutting-plane pass
  (replaces ``_fg_kernel_batched``);
* K3 ``csrc/hist_multi.cu`` behind :func:`cp_histogram_multi` and its K=1
  view :func:`cp_histogram`, and :func:`wcp_histogram_multi` /
  :func:`wcp_histogram` (K3w) — one shared array binned against K ladders
  in one read (replaces ``_hist_kernel_multi``); with ``want_sums`` the
  legs K3s (Σx) and K3ws (Σw·x);
* K4 ``csrc/fg_multi.cu`` behind :func:`cp_partials_multi` and its K=1
  view :func:`cp_partials`, and :func:`wcp_partials_multi` /
  :func:`wcp_partials` (K4w) — the partials of K pivots from one read of a
  shared array (replaces ``_fg_kernel_multi``).

On the weighted leg ``x`` and ``w`` are each f32 or bf16, both read as
f32.  Every f32 sum — the masses that decide the weighted narrowing and
the per-slot sums that place the polish cut included — comes from
per-block partials reduced over blocks here in a fixed order, with a block
count that depends on ``n`` alone, so the same input gives the same bits
from run to run.  Every leg's block sums (K2, K4 and the histogram legs
with f32 rows: K1w, K1s, K1ws, K3w, K3s, K3ws) go through a fifth kernel,
``csrc/sum_blocks.cu`` (:func:`_sum_blocks`, its own ``LAUNCHES`` entry
``sum_blocks``, one launch per pass), whose order depends on the block
count alone: a pivot's partials are the same bits at any K and through
either kernel, and a row's or ladder's masses do not depend on the other
rows or ladders of its launch.

K1 has two designs and its legs with rows two, chosen by
:func:`hist_rows_layout` from the call's shape and whether the ladder's
bracket holds every element (``full_bracket``, the engine's first sweep):
lane-private tables (K1 on such sweeps, K1w and K1s on such sweeps of rows
of at least ``LANE_ROWS_MIN_N`` elements, at widths whose tables fit a
block), a shared histogram (K1 otherwise) and grouped rows (K1w/K1s
otherwise, and K1ws).

Each wrapper checks what the kernel takes and raises on anything else,
allocates the outputs, launches on the current stream, raises on a
non-zero ``cudaGetLastError`` and adds one to its entry in
:data:`LAUNCHES` (a histogram's sums leg to its own ``*_sums`` entry).
The plain versions live in :mod:`repro_torch.kernels.ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

# launches per wrapper since the last reset_launches(); a wrapper adds one
# exactly where it launches its kernel
LAUNCHES = {"cp_histogram_batched": 0, "cp_partials_batched": 0,
            "cp_histogram_multi": 0, "cp_partials_multi": 0,
            "cp_histogram": 0, "cp_partials": 0,
            "wcp_histogram_batched": 0, "wcp_partials_batched": 0,
            "wcp_histogram_multi": 0, "wcp_partials_multi": 0,
            "wcp_histogram": 0, "wcp_partials": 0,
            "cp_histogram_batched_sums": 0, "cp_histogram_multi_sums": 0,
            "cp_histogram_sums": 0, "wcp_histogram_batched_sums": 0,
            "wcp_histogram_multi_sums": 0, "wcp_histogram_sums": 0,
            "sum_blocks": 0}

# K1: its grid aims to fill the card with the blocks an SM holds (integer
# atomics make the counts independent of the block count, so it may follow
# the card); at most HIST_BLOCKS_PER_SM, fewer where the shared memory of
# a block allows fewer (SM_SMEM bytes an SM, SMEM_RESERVED more a block)
HIST_BLOCKS_PER_SM = 8
HIST_THREADS = 256
SM_SMEM = 228 * 1024
SMEM_RESERVED = 1024
# shared memory a block may use without opting in
HIST_MAX_SMEM = 48 * 1024
# lane-private K1/K1w/K1s: warps a block (their rows' f32 chain counts on
# one element per thread and grid stride of HIST_THREADS threads), and the
# most elements of a row per thread and grid stride (its 16-bit counts
# hold 65535; K1's 16-byte packs round a thread's share up by less than a
# pack, 8 elements, and one head or tail element may come on top)
LANE_WARPS = HIST_THREADS // 32
LANE_MAX_PER_THREAD = 65535 - 16
# K2: one block per FG_CHUNK elements of a row, at most FG_MAX_BLOCKS; a
# function of n alone, so the per-block sums and their reduce repeat bit
# for bit from run to run
FG_CHUNK = 8192
FG_MAX_BLOCKS = 1024
# K1w/K1s take the lane-private design from this row length on, where the
# fg_blocks(n) blocks stop growing in number and each bins FG_CHUNK
# elements or more; below it the grouped design's lighter blocks read
# faster
LANE_ROWS_MIN_N = FG_CHUNK * FG_MAX_BLOCKS
MAX_ROWS = 65535  # grid.y limit
# K3: a block holds a power of two of at most 16 ladders (two register
# counters each per thread), only as many as fit in HIST_MAX_SMEM; a single
# ladder past that opts in to at most HIST_OPTIN_SMEM, the most an H100
# block may hold
HIST_MULTI_GROUP = 16
HIST_OPTIN_SMEM = 227 * 1024
# K4: at most 16 pivots share a block (four register accumulators each,
# six on the weighted leg)
FG_MULTI_GROUP = 16
# K1w/K3w and the sums legs: at most 8 warps per block, each with its own
# f32 rows per ladder in shared memory (one: mass or sum; two: mass and
# sum); the block count is fg_blocks(n), so the order of the sums depends
# on n alone
WHIST_MAX_WARPS = 8

_KERNEL_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    "hist_batched": [_P, _P, _P, _I64, _I64, _I32, _I32, _P],
    "fg_batched": [_P, _P, _P, _P, _I64, _I64, _I32, _P],
    "hist_multi": [_P, _P, _P, _I64, _I32, _I32, _I32, _P],
    "fg_multi": [_P, _P, _P, _P, _I64, _I32, _I32, _P],
    "whist_batched": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P],
    "wfg_batched": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _P],
    "whist_multi": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                    _P],
    "wfg_multi": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _P],
    "shist_batched": [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P],
    "wshist_batched": [_P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _P],
    "shist_multi": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32, _P],
    "wshist_multi": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _I32,
                     _P],
    "sum_blocks": [_P, _P, _I64, _I32, _I64, _P],
}
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel_fn(lib_name: str, dtype: torch.dtype, wdtype=None,
               sums: bool = False, lane: bool = False):
    """The C entry of ``csrc/<lib_name>.cu`` for ``x`` of ``dtype`` — on
    the weighted leg (``wdtype``, the weights' dtype) the ``w``-prefixed
    entry for that pair of types, for a histogram's sums leg (``sums``)
    the ``s``-prefixed one, and for K1's lane-private design (``lane``)
    the same entry prefixed ``lane_``."""
    prefix = ("w" if wdtype is not None else "") + ("s" if sums else "") \
        + lib_name
    name = ("lane_" if lane else "") + f"{prefix}_{_KERNEL_DTYPES[dtype]}"
    if wdtype is not None:
        name += f"_{_KERNEL_DTYPES[wdtype]}"
    fn = _fns.get(name)
    if fn is None:
        lib = _build.load(lib_name)
        fn = getattr(lib, name)
        fn.argtypes = _SIGNATURES[prefix]
        fn.restype = ctypes.c_int
        err = lib.cuda_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _fns[name] = fn
        _fns[f"{lib_name}_error"] = err
    return fn


def _raise_on(rc: int, lib_name: str) -> None:
    if rc != 0:
        msg = _fns[f"{lib_name}_error"](rc).decode()
        raise RuntimeError(f"{lib_name} kernel launch failed: CUDA error "
                           f"{rc} ({msg})")


def _check_data(x: torch.Tensor, shared: bool = False) -> None:
    """What K1/K2 (``(B, n)`` rows) or, with ``shared``, K3/K4 (one
    ``(n,)`` array) take."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel input must be a CUDA tensor, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"kernel input must be float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.dim() != (1 if shared else 2):
        want = "(n,)" if shared else "(B, n)"
        raise ValueError(f"kernel input must be {want}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel input must be contiguous")
    if not shared and x.shape[0] > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS} rows per launch, got "
                         f"{x.shape[0]}")
    if x.shape[-1] >= 2 ** 31:
        raise ValueError("int32 counts hold rows of fewer than 2^31 elements")


def _check_weights(w: torch.Tensor, x: torch.Tensor) -> None:
    """What the weighted legs take for ``w``: ``x``'s device and shape,
    f32 or bf16, contiguous."""
    if w.device != x.device:
        raise ValueError(f"w must be on {x.device}, got {w.device}")
    if w.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if w.shape != x.shape:
        raise ValueError(f"w must be shaped like x {tuple(x.shape)}, got "
                         f"{tuple(w.shape)}")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")


def _check_side(t: torch.Tensor, x: torch.Tensor, shape, name: str) -> None:
    if t.device != x.device:
        raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _sum_blocks(part: torch.Tensor) -> torch.Tensor:
    """Sum f32 per-block partials ``(outer, nblk, inner)`` over the block
    axis with ``csrc/sum_blocks.cu``, in an order set by ``nblk`` alone (so
    a pivot's sums do not depend on the other pivots of its launch, nor on
    whether K2 or K4 measured it, and a histogram row's or ladder's masses
    and sums not on the other rows or ladders); returns
    ``(outer, inner)``."""
    outer, nblk, inner = part.shape
    # every output is written (a block sum of zero blocks is +0)
    out = torch.empty((outer, inner), dtype=torch.float32, device=part.device)
    if out.numel() > 0:
        fn = _kernel_fn("sum_blocks", torch.float32)
        with torch.cuda.device(part.device):
            stream = torch.cuda.current_stream(part.device).cuda_stream
            rc = fn(part.data_ptr(), out.data_ptr(), outer, nblk, inner,
                    stream)
        _raise_on(rc, "sum_blocks")
        LAUNCHES["sum_blocks"] += 1
    return out


def lane_hist_smem(nedges: int, nrows: int,
                   warps: int = LANE_WARPS) -> int:
    """Shared bytes of a lane-private block (``LaneLayout`` in
    ``csrc/hist_batched.cu``) with ``nrows`` (0 or 1) f32 rows: the edges
    padded to a power of two, per warp ``nbins`` rows of 32 f32 columns
    (``nrows``) and ``ceil(nbins / 2)`` rows of 32 columns of packed 16-bit
    counts, per warp an f32 reduction row of ``nbins + 2`` slots
    (``nrows``), and the block's ``nbins + 2`` int counts."""
    nb, nslots = nedges - 1, nedges + 1
    pad = 1 << max(0, (nedges - 1).bit_length())
    return 4 * (pad + warps * 32 * (nb * nrows + nedges // 2)
                + warps * nslots * nrows + nslots)


def hist_rows_layout(nedges: int, nrows: int, n: int,
                     full_bracket: bool) -> str:
    """K1's design for rows of ``n`` elements, a ladder of ``nedges``
    edges and ``nrows`` f32 rows per slot (0: K1; 1: K1w, K1s; 2: K1ws):
    ``"lane"`` when the ladder's bracket holds every element
    (``full_bracket``: the first sweep, where every element is binned),
    the lane-private tables (one row at most) fit a block and, with a row,
    ``n >= LANE_ROWS_MIN_N``; else ``"shared"`` (K1) or ``"grouped"``.  On
    a narrow sweep nearly every element lies outside the bracket and costs
    two compares in any design; there the earlier designs, whose small
    blocks fill an SM, read faster.  A rule on the call, never a fallback
    on error."""
    if (full_bracket and nedges >= 2 and nrows <= 1
            and (nrows == 0 or n >= LANE_ROWS_MIN_N)
            and lane_hist_smem(nedges, nrows) <= HIST_OPTIN_SMEM):
        return "lane"
    return "shared" if nrows == 0 else "grouped"


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``HIST_THREADS`` threads with ``smem`` shared bytes each
    that an SM holds, at most ``HIST_BLOCKS_PER_SM``."""
    return max(1, min(HIST_BLOCKS_PER_SM, SM_SMEM // (smem + SMEM_RESERVED)))


def hist_blocks_per_row(rows: int, n: int, sms: int, per_sm: int) -> int:
    """K1's blocks per row: enough for ``per_sm`` blocks on each of
    ``sms`` SMs over all rows, no more than a row has threads' worth of
    elements, and so many that a row gives no thread more than
    ``LANE_MAX_PER_THREAD`` elements per grid stride."""
    per_row = -(-sms * per_sm // rows)
    per_row = max(1, min(per_row, -(-n // HIST_THREADS)))
    return max(per_row, -(-n // (HIST_THREADS * LANE_MAX_PER_THREAD)))


def fg_blocks(n: int) -> int:
    return max(1, min(-(-n // FG_CHUNK), FG_MAX_BLOCKS))


def cp_histogram_batched(x: torch.Tensor, edges: torch.Tensor, *,
                         want_sums: bool = False, full_bracket: bool = False):
    """K1: per-row slot counts of ``x`` (B, n) f32/bf16 against realized
    f32 ``edges`` (B, nbins+1).  Returns ``(cnt, bsum)`` with ``cnt`` int32
    (B, nbins + 2), slot layout as ``ref.searchsorted_slots``; ``bsum`` is
    ``None``, or with ``want_sums`` (the K1s leg) the f32 sums of ``x`` per
    slot.  ``full_bracket`` says that each row's bracket holds all its
    elements (it picks the design, :func:`hist_rows_layout`; the result is
    the same)."""
    if want_sums:
        cnt, part = _hist_rows(x, None, edges, True,
                               "cp_histogram_batched_sums", full_bracket)
        return cnt, part[:, 0]
    _check_data(x)
    rows, n = x.shape
    nedges = edges.shape[-1] if edges.dim() == 2 else 0
    if nedges < 1:
        raise ValueError(f"edges must be (B, nbins + 1), got "
                         f"{tuple(edges.shape)}")
    _check_side(edges, x, (rows, nedges), "edges")
    lane = hist_rows_layout(nedges, 0, n, full_bracket) == "lane"
    smem = lane_hist_smem(nedges, 0) if lane else (2 * nedges + 1) * 4
    if smem > HIST_OPTIN_SMEM:
        raise ValueError(f"{nedges - 1} bins need {smem} bytes of shared "
                         f"memory; a block holds at most {HIST_OPTIN_SMEM}")
    cnt = torch.zeros((rows, nedges + 1), dtype=torch.int32, device=x.device)
    if rows == 0:
        return cnt, None
    fn = _kernel_fn("hist_batched", x.dtype, lane=lane)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), edges.data_ptr(), cnt.data_ptr(), rows, n,
                nedges, hist_blocks_per_row(rows, n, sms,
                                            blocks_per_sm(smem)), stream)
    _raise_on(rc, "hist_batched")
    LAUNCHES["cp_histogram_batched"] += 1
    return cnt, None


def _fg_batched(x: torch.Tensor, w, y: torch.Tensor, key: str):
    """Launch K2 (``w=None``) or K2w on ``x`` (B, n) and pivots ``y`` (B,),
    then reduce the per-block partials in a fixed order; counts one launch
    under ``LAUNCHES[key]``.  Returns the f32 sums (two, or four with
    weights) then the two int32 counts, each (B,)."""
    _check_data(x)
    if w is not None:
        _check_weights(w, x)
    rows, n = x.shape
    y = y.to(torch.float32).contiguous()
    _check_side(y, x, (rows,), "y")
    nblk = fg_blocks(n)
    nsums = 2 if w is None else 4
    fsum = torch.empty((rows, nblk, nsums), dtype=torch.float32,
                       device=x.device)
    cnt = torch.empty((rows, nblk, 2), dtype=torch.int32, device=x.device)
    if rows > 0:
        fn = _kernel_fn("fg_batched", x.dtype, None if w is None else w.dtype)
        data = (x.data_ptr(),) if w is None else (x.data_ptr(), w.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(*data, y.data_ptr(), fsum.data_ptr(), cnt.data_ptr(),
                    rows, n, nblk, stream)
        _raise_on(rc, "fg_batched")
        LAUNCHES[key] += 1
    s = _sum_blocks(fsum)
    c = torch.sum(cnt, dim=1, dtype=torch.int32)
    return (*s.unbind(1), *c.unbind(1))


def cp_partials_batched(x: torch.Tensor, y: torch.Tensor):
    """K2: per-row ``(sum_pos, sum_neg, n_lt, n_le)`` of ``d = x - y`` for
    ``x`` (B, n) f32/bf16 and pivots ``y`` (B,) (cast to f32, as the
    kernel compares in f32).  Sums f32, counts int32, each (B,)."""
    return _fg_batched(x, None, y, "cp_partials_batched")


def hist_multi_group(k: int, nedges: int) -> int:
    """Ladders per block of K3: the smallest power of two that covers ``k``
    up to ``HIST_MULTI_GROUP``, halved while the group's edges and
    histograms overflow ``HIST_MAX_SMEM`` (at least one)."""
    group = 1
    while group < min(k, HIST_MULTI_GROUP):
        group *= 2
    while group > 1 and group * (2 * nedges + 1) * 4 > HIST_MAX_SMEM:
        group //= 2
    return group


def _hist_multi(x: torch.Tensor, edges: torch.Tensor, key: str):
    """Launch K3 on ``x`` (n,) and ``edges`` (K, nbins+1); counts one
    launch under ``LAUNCHES[key]``."""
    _check_data(x, shared=True)
    if edges.dim() != 2 or edges.shape[1] < 1:
        raise ValueError(f"edges must be (K, nbins + 1), got "
                         f"{tuple(edges.shape)}")
    k, nedges = edges.shape
    _check_side(edges, x, (k, nedges), "edges")
    smem = (2 * nedges + 1) * 4
    if smem > HIST_OPTIN_SMEM:
        raise ValueError(f"{nedges - 1} bins need {smem} bytes of shared "
                         f"memory per ladder; a block holds at most "
                         f"{HIST_OPTIN_SMEM}")
    group = hist_multi_group(k, nedges)
    if -(-k // group) > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS * group} ladders per launch, "
                         f"got {k}")
    cnt = torch.zeros((k, nedges + 1), dtype=torch.int32, device=x.device)
    if k == 0:
        return cnt
    fn = _kernel_fn("hist_multi", x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), edges.data_ptr(), cnt.data_ptr(), x.shape[0],
                k, nedges, group, stream)
    _raise_on(rc, "hist_multi")
    LAUNCHES[key] += 1
    return cnt


def cp_histogram_multi(x: torch.Tensor, edges: torch.Tensor, *,
                       want_sums: bool = False):
    """K3: slot counts of one shared ``x`` (n,) f32/bf16 against K realized
    f32 ladders ``edges`` (K, nbins+1).  Returns ``(cnt, bsum)`` with
    ``cnt`` int32 (K, nbins + 2), slot layout as
    ``ref.searchsorted_slots``; ``bsum`` is ``None``, or with
    ``want_sums`` (the K3s leg) the f32 sums of ``x`` per slot."""
    if want_sums:
        cnt, part = _whist_multi(x, None, edges, "cp_histogram_multi_sums",
                                 True)
        return cnt, part[:, 0]
    return _hist_multi(x, edges, "cp_histogram_multi"), None


def cp_histogram(x: torch.Tensor, edges: torch.Tensor, *,
                 want_sums: bool = False):
    """The K=1 view of :func:`cp_histogram_multi`: ``x`` (n,), one ladder
    ``edges`` (nbins+1,); returns ``(cnt, bsum)``, each (nbins + 2,)
    (``bsum`` ``None`` without ``want_sums``)."""
    if edges.dim() != 1:
        raise ValueError(f"edges must be (nbins + 1,), got "
                         f"{tuple(edges.shape)}")
    if want_sums:
        cnt, part = _whist_multi(x, None, edges[None, :],
                                 "cp_histogram_sums", True)
        return cnt[0], part[0, 0]
    return _hist_multi(x, edges[None, :], "cp_histogram")[0], None


def _fg_multi(x: torch.Tensor, w, y: torch.Tensor, key: str):
    """Launch K4 (``w=None``) or K4w on ``x`` (n,) and f32 pivots ``y``
    (K,), then reduce the per-block partials in a fixed order; counts one
    launch under ``LAUNCHES[key]``.  Returns the f32 sums (two, or four
    with weights) then the two int32 counts, each (K,)."""
    _check_data(x, shared=True)
    if w is not None:
        _check_weights(w, x)
    k = y.shape[0]
    _check_side(y, x, (k,), "y")
    if -(-k // FG_MULTI_GROUP) > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS * FG_MULTI_GROUP} pivots per "
                         f"launch, got {k}")
    nblk = fg_blocks(x.shape[0])
    nsums = 2 if w is None else 4
    fsum = torch.empty((nblk, k, nsums), dtype=torch.float32,
                       device=x.device)
    cnt = torch.empty((nblk, k, 2), dtype=torch.int32, device=x.device)
    if k > 0:
        fn = _kernel_fn("fg_multi", x.dtype, None if w is None else w.dtype)
        data = (x.data_ptr(),) if w is None else (x.data_ptr(), w.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(*data, y.data_ptr(), fsum.data_ptr(), cnt.data_ptr(),
                    x.shape[0], k, nblk, stream)
        _raise_on(rc, "fg_multi")
        LAUNCHES[key] += 1
    s = _sum_blocks(fsum.view(1, nblk, k * nsums)).view(k, nsums)
    c = torch.sum(cnt, dim=0, dtype=torch.int32)
    return (*s.unbind(1), *c.unbind(1))


def _pivots(x: torch.Tensor, y) -> torch.Tensor:
    """Pivots ``y`` as the (K,) f32 vector K4 compares in."""
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device)
    if y.dim() != 1:
        raise ValueError(f"y must be (K,), got {tuple(y.shape)}")
    return y.contiguous()


def cp_partials_multi(x: torch.Tensor, y: torch.Tensor):
    """K4: ``(sum_pos, sum_neg, n_lt, n_le)`` of ``d = x - y_k`` for one
    shared ``x`` (n,) f32/bf16 and pivots ``y`` (K,) (cast to f32, as the
    kernel compares in f32).  Sums f32, counts int32, each (K,)."""
    return _fg_multi(x, None, _pivots(x, y), "cp_partials_multi")


def cp_partials(x: torch.Tensor, y):
    """The K=1 view of :func:`cp_partials_multi`: ``x`` (n,) and a scalar
    pivot; returns four 0-dim tensors."""
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device).reshape(1)
    return tuple(p[0] for p in _fg_multi(x, None, y, "cp_partials"))


# ---------------------------------------------------------------------------
# Weighted leg (K1w-K4w): the same sources, specialized on the weight type
# ---------------------------------------------------------------------------


def whist_smem(group: int, warps: int, nedges: int, nrows: int = 1) -> int:
    """Shared bytes of a K1w/K1s/K1ws (``group`` 1) or K3w/K3s/K3ws block:
    the edges, ``nrows`` f32 rows (mass, sum, or both) per warp and ladder,
    a stage of 32 floats per warp and row, and the int counts per
    ladder."""
    nslots = nedges + 1
    return 4 * (group * nedges + warps * group * nslots * nrows
                + warps * 32 * nrows + group * nslots)


def whist_layout(k: int, nedges: int, nrows: int = 1) -> tuple[int, int]:
    """``(group, warps)`` of a histogram block with ``nrows`` f32 rows per
    slot: the smallest power of two of ladders that covers ``k`` up to
    ``HIST_MULTI_GROUP`` and ``WHIST_MAX_WARPS`` warps, the group halved and
    then the warps halved while the block overflows ``HIST_OPTIN_SMEM``.
    Raises when one ladder and one warp do not fit."""
    group = 1
    while group < min(k, HIST_MULTI_GROUP):
        group *= 2
    warps = WHIST_MAX_WARPS

    def smem():
        return whist_smem(group, warps, nedges, nrows)

    while group > 1 and smem() > HIST_OPTIN_SMEM:
        group //= 2
    while warps > 1 and smem() > HIST_OPTIN_SMEM:
        warps //= 2
    if smem() > HIST_OPTIN_SMEM:
        raise ValueError(f"{nedges - 1} bins need "
                         f"{whist_smem(1, 1, nedges, nrows)} bytes of shared "
                         f"memory per block with {nrows} f32 row(s) per "
                         f"slot; a block holds at most {HIST_OPTIN_SMEM}")
    return group, warps


def _hist_rows(x: torch.Tensor, w, edges: torch.Tensor, want_sums: bool,
               key: str, full_bracket: bool = False):
    """Launch the row-wise histogram leg with f32 slot rows on ``x`` (B, n)
    and ``edges`` (B, nbins+1): K1w (``w``, no sums), K1s (no ``w``, sums)
    or K1ws (``w`` and sums), in the design :func:`hist_rows_layout` picks
    (``full_bracket``: every element lies in its row's bracket);
    then reduce the per-block rows with :func:`_sum_blocks`; counts one
    launch under ``LAUNCHES[key]``.  Returns the int32
    counts (B, nbins + 2) and the f32 rows (B, R, nbins + 2): the mass or
    the sum (R = 1), or the mass and the sum (R = 2)."""
    _check_data(x)
    if w is not None:
        _check_weights(w, x)
    rows, n = x.shape
    nedges = edges.shape[-1] if edges.dim() == 2 else 0
    if nedges < 1:
        raise ValueError(f"edges must be (B, nbins + 1), got "
                         f"{tuple(edges.shape)}")
    _check_side(edges, x, (rows, nedges), "edges")
    nrows = 2 if w is not None and want_sums else 1
    lane = hist_rows_layout(nedges, nrows, n, full_bracket) == "lane"
    warps = LANE_WARPS if lane else whist_layout(1, nedges, nrows)[1]
    nblk = fg_blocks(n)
    cnt = torch.zeros((rows, nedges + 1), dtype=torch.int32, device=x.device)
    part = torch.empty((rows, nblk, nrows, nedges + 1), dtype=torch.float32,
                       device=x.device)
    if rows > 0:
        fn = _kernel_fn("hist_batched", x.dtype,
                        None if w is None else w.dtype, sums=want_sums,
                        lane=lane)
        data = (x.data_ptr(),) if w is None else (x.data_ptr(), w.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(*data, edges.data_ptr(), cnt.data_ptr(), part.data_ptr(),
                    rows, n, nedges, nblk, warps, stream)
        _raise_on(rc, "hist_batched")
        LAUNCHES[key] += 1
    sums = _sum_blocks(part.view(rows, nblk, nrows * (nedges + 1)))
    return cnt, sums.view(rows, nrows, nedges + 1)


def wcp_histogram_batched(x: torch.Tensor, w: torch.Tensor,
                          edges: torch.Tensor, *, want_sums: bool = False,
                          full_bracket: bool = False):
    """K1w: per-row slot counts and masses of ``x``/``w`` (B, n), each
    f32/bf16, against realized f32 ``edges`` (B, nbins+1).  Returns
    ``(cnt, wcnt, wsum)``: int32 counts and f32 masses, each
    (B, nbins + 2), slot layout as ``ref.searchsorted_slots``; ``wsum`` is
    ``None``, or with ``want_sums`` (the K1ws leg) the f32 sums of ``w*x``
    per slot.  ``full_bracket`` as in :func:`cp_histogram_batched` (the
    design, and so the last bits of dense masses, may follow it)."""
    key = "wcp_histogram_batched" + ("_sums" if want_sums else "")
    cnt, part = _hist_rows(x, w, edges, want_sums, key, full_bracket)
    return cnt, part[:, 0], (part[:, 1] if want_sums else None)


def wcp_partials_batched(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """K2w: per-row ``(wsum_pos, wsum_neg, w_lt, w_le, n_lt, n_le)`` of
    ``d = x - y`` for ``x``/``w`` (B, n), each f32/bf16, and pivots ``y``
    (B,) (cast to f32, as the kernel compares in f32).  Sums and masses
    f32, counts int32, each (B,)."""
    return _fg_batched(x, w, y, "wcp_partials_batched")


def _whist_multi(x: torch.Tensor, w, edges: torch.Tensor, key: str,
                 want_sums: bool = False):
    """Launch the shared-x histogram leg with f32 slot rows on ``x`` (n,)
    and ``edges`` (K, nbins+1): K3w (``w``, no sums), K3s (no ``w``, sums)
    or K3ws (``w`` and sums); then reduce the per-block rows with
    :func:`_sum_blocks`; counts one launch under ``LAUNCHES[key]``.  Returns the int32
    counts (K, nbins + 2) and the f32 rows (K, R, nbins + 2), as
    :func:`_hist_rows`."""
    _check_data(x, shared=True)
    if w is not None:
        _check_weights(w, x)
    if edges.dim() != 2 or edges.shape[1] < 1:
        raise ValueError(f"edges must be (K, nbins + 1), got "
                         f"{tuple(edges.shape)}")
    k, nedges = edges.shape
    _check_side(edges, x, (k, nedges), "edges")
    nrows = 2 if w is not None and want_sums else 1
    group, warps = whist_layout(k, nedges, nrows)
    if -(-k // group) > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS * group} ladders per launch, "
                         f"got {k}")
    nblk = fg_blocks(x.shape[0])
    cnt = torch.zeros((k, nedges + 1), dtype=torch.int32, device=x.device)
    part = torch.empty((nblk, k, nrows, nedges + 1), dtype=torch.float32,
                       device=x.device)
    if k > 0:
        fn = _kernel_fn("hist_multi", x.dtype,
                        None if w is None else w.dtype, sums=want_sums)
        data = (x.data_ptr(),) if w is None else (x.data_ptr(), w.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(*data, edges.data_ptr(), cnt.data_ptr(), part.data_ptr(),
                    x.shape[0], k, nedges, group, nblk, warps, stream)
        _raise_on(rc, "hist_multi")
        LAUNCHES[key] += 1
    sums = _sum_blocks(part.view(1, nblk, k * nrows * (nedges + 1)))
    return cnt, sums.view(k, nrows, nedges + 1)


def wcp_histogram_multi(x: torch.Tensor, w: torch.Tensor,
                        edges: torch.Tensor, *, want_sums: bool = False):
    """K3w: slot counts and masses of one shared ``x``/``w`` (n,), each
    f32/bf16, against K realized f32 ladders ``edges`` (K, nbins+1).
    Returns ``(cnt, wcnt, wsum)``: int32 counts and f32 masses, each
    (K, nbins + 2), slot layout as ``ref.searchsorted_slots``; ``wsum`` is
    ``None``, or with ``want_sums`` (the K3ws leg) the f32 sums of ``w*x``
    per slot."""
    key = "wcp_histogram_multi" + ("_sums" if want_sums else "")
    cnt, part = _whist_multi(x, w, edges, key, want_sums)
    return cnt, part[:, 0], (part[:, 1] if want_sums else None)


def wcp_histogram(x: torch.Tensor, w: torch.Tensor, edges: torch.Tensor, *,
                  want_sums: bool = False):
    """The K=1 view of :func:`wcp_histogram_multi`: ``x``/``w`` (n,), one
    ladder ``edges`` (nbins+1,); returns ``(cnt, wcnt, wsum)``, each
    (nbins + 2,) (``wsum`` ``None`` without ``want_sums``)."""
    if edges.dim() != 1:
        raise ValueError(f"edges must be (nbins + 1,), got "
                         f"{tuple(edges.shape)}")
    key = "wcp_histogram" + ("_sums" if want_sums else "")
    cnt, part = _whist_multi(x, w, edges[None, :], key, want_sums)
    return cnt[0], part[0, 0], (part[0, 1] if want_sums else None)


def wcp_partials_multi(x: torch.Tensor, w: torch.Tensor, y: torch.Tensor):
    """K4w: ``(wsum_pos, wsum_neg, w_lt, w_le, n_lt, n_le)`` of
    ``d = x - y_k`` for one shared ``x``/``w`` (n,), each f32/bf16, and
    pivots ``y`` (K,) (cast to f32, as the kernel compares in f32).  Sums
    and masses f32, counts int32, each (K,)."""
    return _fg_multi(x, w, _pivots(x, y), "wcp_partials_multi")


def wcp_partials(x: torch.Tensor, w: torch.Tensor, y):
    """The K=1 view of :func:`wcp_partials_multi`: ``x``/``w`` (n,) and a
    scalar pivot; returns six 0-dim tensors."""
    y = torch.as_tensor(y, dtype=torch.float32, device=x.device).reshape(1)
    return tuple(p[0] for p in _fg_multi(x, w, y, "wcp_partials"))
