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
  legs K3s (Σx) and K3ws (Σw·x), in ``csrc/hist_multi_sums.cu``: each
  chunk of the array sorted once for all ladders, each slot a direct sum
  over its sorted positions;
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
lane-private tables (K1 on such sweeps, K1w on such sweeps of rows of at
least ``LANE_ROWS_MIN_N`` elements, at widths whose tables fit a block),
lane-column tables with a bucket slot lookup (K1s and K1ws on such sweeps
of rows of at least ``LANE_SUMS_MIN_N``), a shared histogram (K1
otherwise) and grouped rows (K1w, K1s and K1ws otherwise).  K3s and K3ws
take the sorted-tile design on every ladder of which one fits a block's
shared memory (up to 12255 edges for K3s, 9650 for K3ws), and the grouped
rows of ``csrc/hist_multi.cu`` on wider ones
(:func:`hist_multi_sums_layout`: a rule on the width and the leg, never on
K, so a ladder alone and among others runs the same design).

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
            "sum_blocks": 0, "row_sums": 0}

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
# K1w takes the lane-private design from this row length on, where the
# fg_blocks(n) blocks stop growing in number and each bins FG_CHUNK
# elements or more; below it the grouped design's lighter blocks read
# faster
LANE_ROWS_MIN_N = FG_CHUNK * FG_MAX_BLOCKS
# K1s/K1ws, lane-column design: buckets of the slot lookup
# (``kBuckets`` in csrc/hist_batched.cu; 16 bytes each: a slot and its
# three edges), the edges a lane holds in registers for the warp's search
# (``kEdgeRegs``: ladders of at most 32 times as many edges), the row
# length from which it runs (K1w's: at (64, 2^20) the grouped design reads
# faster, PERF.md), and the designs a caller may ask ``_hist_rows`` for by
# name
SUMS_BUCKETS = 1024
SUMS_EDGE_REGS = 5
LANE_SUMS_MIN_N = LANE_ROWS_MIN_N
ROWS_SUMS_DESIGNS = ("lane_sums", "grouped")
# ... its warps a block (by f32 rows per slot, 1 or 2: the most whose
# tables fit a block at 128 bins; at most SUMS_MAX_WARPS,
# ``kSumsMaxThreads`` in csrc/hist_batched.cu), and how its threads walk a
# row (``kGroup``, ``SumsShape::groups``, ``kChunk``): groups of 4
# elements, batches of 8 groups (K1s) or 4 (K1ws) while every lane of the
# warp has one, binned 8 elements at a time, then one group at a time;
# the order of the f32 adds follows them
SUMS_WARPS = {1: 12, 2: 11}
SUMS_MAX_WARPS = 12
SUMS_GROUP = 4
SUMS_BATCH_GROUPS = {1: 8, 2: 4}
SUMS_CHUNK = 8
MAX_ROWS = 65535  # grid.y limit
# K3: a block holds a power of two of at most 16 ladders (two register
# counters each per thread), only as many as fit in HIST_MAX_SMEM; a single
# ladder past that opts in to at most HIST_OPTIN_SMEM, the most an H100
# block may hold
HIST_MULTI_GROUP = 16
HIST_OPTIN_SMEM = 227 * 1024
# K3 and K3w: elements a thread bins per batch (``kUnroll`` in
# csrc/hist_multi.cu; K3w stages a batch's row values per warp)
HIST_MULTI_UNROLL = 4
# K4: at most 16 pivots share a block (four register accumulators each,
# six on the weighted leg)
FG_MULTI_GROUP = 16
# K3s/K3ws, sorted-tile design: a block of SORTED_THREADS threads sorts
# chunks of SORTED_TILE elements (SORTED_ITEMS a thread: its strip of sorted
# positions) and holds at most HIST_MULTI_GROUP ladders; ladders too wide
# for one a block take the grouped design
SORTED_THREADS = 256
SORTED_ITEMS = 16
SORTED_TILE = SORTED_THREADS * SORTED_ITEMS
# the sorted-tile kernel's static shared arrays (rep, dl, nd, wtot: 208
# bytes for K3s, 272 for K3ws as built for sm_90a), rounded up: they count
# against HIST_OPTIN_SMEM with the dynamic layout
SORTED_STATIC_SMEM = 512
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
    "shist_multi_sums": [_P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32, _P],
    "wshist_multi_sums": [_P, _P, _P, _P, _P, _I64, _I32, _I32, _I32, _I32,
                          _P],
    "sum_blocks": [_P, _P, _I64, _I32, _I64, _P],
    "row_sums": [_P, _P, _I64, _I64, _I32, _P],
    "wrow_sums": [_P, _P, _P, _P, _I64, _I64, _I32, _I32, _P],
}
_fns: dict = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _kernel_fn(lib_name: str, dtype: torch.dtype, wdtype=None,
               sums: bool = False, lane: bool = False, entry: str = ""):
    """The C entry of ``csrc/<lib_name>.cu`` for ``x`` of ``dtype`` — on
    the weighted leg (``wdtype``, the weights' dtype) the ``w``-prefixed
    entry for that pair of types, for a histogram's sums leg (``sums``)
    the ``s``-prefixed one, and for K1's lane-private design (``lane``)
    the same entry prefixed ``lane_``; ``entry`` names an entry other than
    the library's own."""
    prefix = ("w" if wdtype is not None else "") + ("s" if sums else "") \
        + (entry or lib_name)
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


# what row_sums adds up per element of a row with weights (``mode``): w
# ("mass"), w*x ("moment"), w over x <= c ("le"), w over x < c ("lt")
ROW_MODES = {"mass": 0, "moment": 1, "le": 2, "lt": 3}


def row_sums(x: torch.Tensor, w=None, c=None, mode: str = "mass"):
    """Per-row f32 sums over ``x`` (B, n) f32/bf16: of ``x`` itself
    (``w=None``), or of the weights ``w`` (B, n) f32/bf16 as ``mode``
    (:data:`ROW_MODES`) says, ``c`` (B,) the per-row bound of ``"le"`` /
    ``"lt"`` (compared in f32).  Each row is summed in an order set
    by ``n`` alone: per-block partials of ``fg_blocks(n)`` blocks
    (``csrc/sum_blocks.cu``, ``row_partials_kernel``), then
    :func:`_sum_blocks`, so a row gets the same bits alone as in any
    batch.  Not a TPU kernel: it takes the place of the reference's
    ``jnp.sum(..., axis=1)`` on the rows path.  Returns (B,) f32."""
    _check_data(x)
    if w is not None:
        _check_weights(w, x)
    rows, n = x.shape
    if w is not None and mode not in ROW_MODES:
        raise ValueError(f"unknown row_sums mode {mode!r}")
    if w is not None and mode in ("le", "lt"):
        c = c.to(torch.float32).contiguous()
        _check_side(c, x, (rows,), "c")
    else:
        c = None
    nblk = fg_blocks(n)
    part = torch.empty((rows, nblk, 1), dtype=torch.float32, device=x.device)
    if rows > 0:
        fn = _kernel_fn("sum_blocks", x.dtype, None if w is None else w.dtype,
                        entry="row_sums")
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            if w is None:
                rc = fn(x.data_ptr(), part.data_ptr(), rows, n, nblk, stream)
            else:
                rc = fn(x.data_ptr(), w.data_ptr(),
                        None if c is None else c.data_ptr(),
                        part.data_ptr(), rows, n, nblk, ROW_MODES[mode],
                        stream)
        _raise_on(rc, "sum_blocks")
        LAUNCHES["row_sums"] += 1
    return _sum_blocks(part).view(rows)


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


def lane_sums_smem(nedges: int, nrows: int, warps: int | None = None) -> int:
    """Shared bytes of a lane-column block of K1s (``nrows`` 1) or K1ws (2)
    of ``warps`` warps (by default ``SUMS_WARPS[nrows]``; ``SumsLayout`` in
    ``csrc/hist_batched.cu``): ``SUMS_BUCKETS`` buckets of 16 bytes, the
    edges padded to a power of two above ``nedges``, per warp ``nbins``
    rows of ``32 / nrows`` columns of ``nrows`` f32 values (two lanes share
    a K1ws column), an int count row and ``nrows`` f32 reduction rows of
    ``nbins + 2`` slots, and the block's ``nbins + 2`` int counts."""
    warps = warps or SUMS_WARPS[nrows]
    nb, nslots = nedges - 1, nedges + 1
    pad = 1 << max(0, nedges.bit_length())
    return 4 * (4 * SUMS_BUCKETS + pad
                + warps * (nb * 32 + (1 + nrows) * nslots) + nslots)


def hist_rows_layout(nedges: int, nrows: int, n: int,
                     full_bracket: bool, sums: bool = False) -> str:
    """K1's design for rows of ``n`` elements, a ladder of ``nedges``
    edges and ``nrows`` f32 rows per slot (0: K1; 1: K1w, or K1s with
    ``sums``; 2: K1ws), on a sweep whose bracket holds every element
    (``full_bracket``: the first, where every element is binned):
    ``"lane"`` (K1, and K1w from ``LANE_ROWS_MIN_N``) where the
    lane-private tables fit a block, ``"lane_sums"`` (K1s and K1ws from
    ``LANE_SUMS_MIN_N``) where the lane-column tables fit; else
    ``"shared"`` (K1) or ``"grouped"``.  On a narrow sweep nearly every
    element lies outside the bracket and costs two compares in any design;
    there the earlier designs, whose small blocks fill an SM, read faster.
    A rule on the call, never on the batch, never a fallback on error."""
    if full_bracket and nedges >= 2:
        if sums or nrows == 2:
            if (n >= LANE_SUMS_MIN_N and nedges <= 32 * SUMS_EDGE_REGS
                    and lane_sums_smem(nedges, nrows) <= HIST_OPTIN_SMEM):
                return "lane_sums"
        elif ((nrows == 0 or n >= LANE_ROWS_MIN_N)
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
    cnt = _count_rows(x, edges, full_bracket)
    if cnt.shape[0] > 0:
        LAUNCHES["cp_histogram_batched"] += 1
    return cnt, None


def _count_rows(x: torch.Tensor, edges: torch.Tensor,
                full_bracket: bool) -> torch.Tensor:
    """Launch K1's counting leg on ``x`` (B, n) and ``edges`` (B, nbins+1)
    in the design :func:`hist_rows_layout` picks (no launch for B = 0);
    returns the int32 counts (B, nbins + 2).  The caller counts the
    launch."""
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
        return cnt
    fn = _kernel_fn("hist_batched", x.dtype, lane=lane)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), edges.data_ptr(), cnt.data_ptr(), rows, n,
                nedges, hist_blocks_per_row(rows, n, sms,
                                            blocks_per_sm(smem)), stream)
    _raise_on(rc, "hist_batched")
    return cnt


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


def hist_multi_smem(group: int, warps: int, nedges: int, nrows: int) -> int:
    """Dynamic shared bytes of a ``csrc/hist_multi.cu`` block (``Layout``)
    of ``group`` ladders of ``nedges`` edges, ``warps`` warps and ``nrows``
    f32 rows per slot (0: K3; 1: K3w, K3s; 2: K3ws): per ladder its edges,
    int counts, guess and end ranks; the sorted bracket ends, and per
    bucket (2 * group + 2) three ladder masks and a total; per warp the
    lanes' 16-bit bucket counters (group + 1 words of 32 lanes), ``nrows``
    f32 rows per ladder and slot, and a stage of 32 values per row and
    step of a batch (``HIST_MULTI_UNROLL``)."""
    nslots, nbuckets = nedges + 1, 2 * group + 2
    return 4 * (group * (nedges + nslots) + 2 * group + 4 * nbuckets
                + 4 * group + warps * (group + 1) * 32
                + warps * group * nslots * nrows
                + warps * 32 * nrows * HIST_MULTI_UNROLL)


def hist_multi_group(k: int, nedges: int) -> int:
    """Ladders per block of K3 (``HIST_THREADS`` threads): the smallest
    power of two that covers ``k`` up to ``HIST_MULTI_GROUP``, halved while
    the block overflows ``HIST_MAX_SMEM`` (at least one)."""
    group = 1
    while group < min(k, HIST_MULTI_GROUP):
        group *= 2
    while group > 1 and hist_multi_smem(group, LANE_WARPS, nedges, 0) \
            > HIST_MAX_SMEM:
        group //= 2
    return group


def one_ladder(edges: torch.Tensor, full_bracket: bool) -> bool:
    """Whether a sweep whose brackets hold every element (``full_bracket``)
    bins one ladder: K = 1, or every ladder of ``edges`` (K, nbins+1) is
    the first (the first sweep of a multi-k solve without a prior; one
    device-to-host read).  Such a sweep bins the one ladder and copies its
    outputs to the K rows: K3's counts are exact in any design, and a
    ladder's K3w masses are the same bits alone as among any company, so
    the copies are what the K ladders would get."""
    return (full_bracket and edges.shape[0] > 0
            and (edges.shape[0] == 1
                 or bool(torch.equal(edges, edges[:1].expand_as(edges)))))


def _hist_multi(x: torch.Tensor, edges: torch.Tensor, key: str,
                full_bracket: bool = False):
    """Launch K3 on ``x`` (n,) and ``edges`` (K, nbins+1) (on a first sweep
    of one ladder, :func:`one_ladder`, K1's lane-private kernel on it where
    K1 takes its lane design at this width); counts one launch under
    ``LAUNCHES[key]``."""
    _check_data(x, shared=True)
    if edges.dim() != 2 or edges.shape[1] < 1:
        raise ValueError(f"edges must be (K, nbins + 1), got "
                         f"{tuple(edges.shape)}")
    k, nedges = edges.shape
    _check_side(edges, x, (k, nedges), "edges")
    if (hist_rows_layout(nedges, 0, x.shape[0], True) == "lane"
            and one_ladder(edges, full_bracket)):
        one = _count_rows(x.view(1, -1), edges[:1], True)
        LAUNCHES[key] += 1
        return one.expand(k, -1).contiguous()
    smem = hist_multi_smem(1, LANE_WARPS, nedges, 0)
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
                       want_sums: bool = False, full_bracket: bool = False):
    """K3: slot counts of one shared ``x`` (n,) f32/bf16 against K realized
    f32 ladders ``edges`` (K, nbins+1).  Returns ``(cnt, bsum)`` with
    ``cnt`` int32 (K, nbins + 2), slot layout as
    ``ref.searchsorted_slots``; ``bsum`` is ``None``, or with
    ``want_sums`` (the K3s leg) the f32 sums of ``x`` per slot.
    ``full_bracket`` says that every bracket holds every element (it may
    pick K3's design, :func:`one_ladder`; the counts are the same)."""
    if want_sums:
        cnt, part = _whist_multi(x, None, edges, "cp_histogram_multi_sums",
                                 True)
        return cnt, part[:, 0]
    return _hist_multi(x, edges, "cp_histogram_multi", full_bracket), None


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
    """Shared bytes of a grouped K1w/K1s/K1ws block (``group`` 1;
    ``csrc/hist_batched.cu``): the edges, ``nrows`` f32 rows (mass, sum, or
    both) per warp and ladder, a stage of 32 floats per warp and row, and
    the int counts per ladder.  ``csrc/hist_multi.cu``'s blocks:
    :func:`hist_multi_smem`."""
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


def sorted_sums_smem(group: int, nedges: int, nrows: int) -> int:
    """Dynamic shared bytes of a K3s (``nrows`` 1) or K3ws (2) block of the
    sorted-tile design (``Layout`` in ``csrc/hist_multi_sums.cu``): the
    sorted chunk's keys and one row of values (the sort's own storage
    reuses them), per row the sum of each thread's strip of
    ``SORTED_ITEMS`` sorted positions and the exclusive sums of the strips
    before and after it, and per ladder its edge keys and boundaries,
    ``nrows`` f32 rows and the int counts of its ``nedges + 1`` slots."""
    nslots = nedges + 1
    return 4 * (2 * SORTED_TILE + 3 * nrows * SORTED_THREADS
                + group * (2 * nedges + (nrows + 1) * nslots))


def hist_multi_sums_layout(nedges: int, nrows: int) -> str:
    """K3s's (``nrows`` 1) or K3ws's (2) design for ladders of ``nedges``
    edges: ``"sorted"`` (``csrc/hist_multi_sums.cu``) wherever a block of
    one such ladder fits ``HIST_OPTIN_SMEM`` (up to 12255 edges for K3s,
    9650 for K3ws), else ``"grouped"`` (``csrc/hist_multi.cu``), which
    fits wider ladders.  The sorted tile was as fast or faster at 16
    ladders of every width timed, and at one ladder from 2049 edges on
    (PERF.md); at one narrow ladder the grouped kernel is faster, but the
    rule depends on the width and the leg alone, never on K or the other
    ladders, so a ladder's sums are the same bits alone and in company.  A
    rule on the call, never a fallback on error."""
    fits = _sorted_fits(1, nedges, nrows)
    return "sorted" if nedges >= 2 and fits else "grouped"


def _sorted_fits(group: int, nedges: int, nrows: int) -> bool:
    """Whether a sorted-tile block of ``group`` ladders fits
    ``HIST_OPTIN_SMEM`` with the kernel's static arrays."""
    return sorted_sums_smem(group, nedges, nrows) + SORTED_STATIC_SMEM <= \
        HIST_OPTIN_SMEM


def sorted_sums_group(k: int, nedges: int, nrows: int) -> int:
    """Ladders per block of the sorted-tile design: the smallest power of
    two that covers ``k`` up to ``HIST_MULTI_GROUP``, halved while the
    block's dynamic and static shared bytes overflow ``HIST_OPTIN_SMEM``
    (each group of ladders sorts the array again; the sums do not depend
    on the grouping)."""
    if not _sorted_fits(1, nedges, nrows):
        raise ValueError(f"{nedges - 1} bins need "
                         f"{sorted_sums_smem(1, nedges, nrows)} bytes of "
                         f"shared memory per sorted-tile block with {nrows} "
                         f"f32 row(s) per slot; a block holds at most "
                         f"{HIST_OPTIN_SMEM - SORTED_STATIC_SMEM} besides "
                         f"its static arrays")
    group = 1
    while group < min(k, HIST_MULTI_GROUP):
        group *= 2
    while group > 1 and not _sorted_fits(group, nedges, nrows):
        group //= 2
    return group


def hist_multi_layout(k: int, nedges: int, nrows: int) -> tuple[int, int]:
    """``(group, warps)`` of a ``csrc/hist_multi.cu`` block with ``nrows``
    f32 rows per slot (K3w, K3s: 1; K3ws: 2): the warps from the width and
    the leg alone (``WHIST_MAX_WARPS``, halved while a block of one ladder
    overflows ``HIST_OPTIN_SMEM``), so that a ladder's order of additions
    never follows K; then the smallest power of two of ladders that covers
    ``k`` up to ``HIST_MULTI_GROUP``, halved while the block overflows.
    Raises when one ladder and one warp do not fit."""
    warps = WHIST_MAX_WARPS
    while warps > 1 and hist_multi_smem(1, warps, nedges, nrows) \
            > HIST_OPTIN_SMEM:
        warps //= 2
    if hist_multi_smem(1, warps, nedges, nrows) > HIST_OPTIN_SMEM:
        raise ValueError(f"{nedges - 1} bins need "
                         f"{hist_multi_smem(1, 1, nedges, nrows)} bytes of "
                         f"shared memory per block with {nrows} f32 row(s) "
                         f"per slot; a block holds at most {HIST_OPTIN_SMEM}")
    group = 1
    while group < min(k, HIST_MULTI_GROUP):
        group *= 2
    while group > 1 and hist_multi_smem(group, warps, nedges, nrows) \
            > HIST_OPTIN_SMEM:
        group //= 2
    return group, warps


def whist_multi_plan(k: int, nedges: int, nrows: int, want_sums: bool,
                     design: str | None = None):
    """``(library, ladders a block, extra launch arguments)`` of a K3w,
    K3s (``nrows`` 1) or K3ws (2) launch on ``k`` ladders of ``nedges``
    edges: a sums leg in ``design`` (by default
    :func:`hist_multi_sums_layout`'s, which does not follow ``k``), the
    sorted tile in ``hist_multi_sums``, K3w and the grouped design in
    ``hist_multi`` with :func:`hist_multi_layout`'s warps (which do not
    follow ``k`` either)."""
    design = design or hist_multi_sums_layout(nedges, nrows)
    if want_sums and design == "sorted":
        return "hist_multi_sums", sorted_sums_group(k, nedges, nrows), ()
    group, warps = hist_multi_layout(k, nedges, nrows)
    return "hist_multi", group, (warps,)


def _hist_rows(x: torch.Tensor, w, edges: torch.Tensor, want_sums: bool,
               key: str, full_bracket: bool = False,
               design: str | None = None):
    """Launch the row-wise histogram leg with f32 slot rows on ``x`` (B, n)
    and ``edges`` (B, nbins+1): K1w (``w``, no sums), K1s (no ``w``, sums)
    or K1ws (``w`` and sums), in the design :func:`hist_rows_layout` picks
    (``full_bracket``: every element lies in its row's bracket; a sums leg
    on such a sweep may be asked for another of ``ROWS_SUMS_DESIGNS`` by
    ``design``, to time or test both at one call);
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
    if design is None:
        design = hist_rows_layout(nedges, nrows, n, full_bracket, want_sums)
    elif not (want_sums and full_bracket and design in ROWS_SUMS_DESIGNS):
        raise ValueError(f"design {design!r} is not one of "
                         f"{ROWS_SUMS_DESIGNS} on a sums leg's first sweep")
    if design == "lane_sums" and (nedges > 32 * SUMS_EDGE_REGS or
                                  lane_sums_smem(nedges, nrows)
                                  > HIST_OPTIN_SMEM):
        raise ValueError(f"{nedges - 1} bins do not fit the lane-column "
                         f"design's block")
    lane = design in ("lane", "lane_sums")
    warps = (SUMS_WARPS[nrows] if design == "lane_sums" else LANE_WARPS
             if lane else whist_layout(1, nedges, nrows)[1])
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
                 want_sums: bool = False, design: str | None = None):
    """Launch the shared-x histogram leg with f32 slot rows on ``x`` (n,)
    and ``edges`` (K, nbins+1): K3w (``w``, no sums), K3s (no ``w``, sums)
    or K3ws (``w`` and sums), the sums legs in the design
    :func:`hist_multi_sums_layout` picks (``design`` names another, to time
    or test both at one width); then reduce the per-block rows
    with :func:`_sum_blocks`; counts one launch under ``LAUNCHES[key]``.
    Returns the int32 counts (K, nbins + 2) and the f32 rows
    (K, R, nbins + 2), as :func:`_hist_rows`."""
    _check_data(x, shared=True)
    if w is not None:
        _check_weights(w, x)
    if edges.dim() != 2 or edges.shape[1] < 1:
        raise ValueError(f"edges must be (K, nbins + 1), got "
                         f"{tuple(edges.shape)}")
    k, nedges = edges.shape
    _check_side(edges, x, (k, nedges), "edges")
    nrows = 2 if w is not None and want_sums else 1
    lib, group, extra = whist_multi_plan(k, nedges, nrows, want_sums, design)
    if -(-k // group) > MAX_ROWS:
        raise ValueError(f"at most {MAX_ROWS * group} ladders per launch, "
                         f"got {k}")
    nblk = fg_blocks(x.shape[0])
    if lib == "hist_multi" and -(-x.shape[0] // (nblk * extra[0] * 32)) \
            > 65535:
        raise ValueError(f"{x.shape[0]} elements give a thread more than "
                         f"65535 at {extra[0]} warps a block: its 16-bit "
                         f"bucket counters would carry")
    cnt = torch.zeros((k, nedges + 1), dtype=torch.int32, device=x.device)
    part = torch.empty((nblk, k, nrows, nedges + 1), dtype=torch.float32,
                       device=x.device)
    if k > 0:
        fn = _kernel_fn(lib, x.dtype, None if w is None else w.dtype,
                        sums=want_sums)
        data = (x.data_ptr(),) if w is None else (x.data_ptr(), w.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            rc = fn(*data, edges.data_ptr(), cnt.data_ptr(), part.data_ptr(),
                    x.shape[0], k, nedges, group, nblk, *extra, stream)
        _raise_on(rc, lib)
        LAUNCHES[key] += 1
    sums = _sum_blocks(part.view(1, nblk, k * nrows * (nedges + 1)))
    return cnt, sums.view(k, nrows, nedges + 1)


def wcp_histogram_multi(x: torch.Tensor, w: torch.Tensor,
                        edges: torch.Tensor, *, want_sums: bool = False,
                        full_bracket: bool = False):
    """K3w: slot counts and masses of one shared ``x``/``w`` (n,), each
    f32/bf16, against K realized f32 ladders ``edges`` (K, nbins+1).
    Returns ``(cnt, wcnt, wsum)``: int32 counts and f32 masses, each
    (K, nbins + 2), slot layout as ``ref.searchsorted_slots``; ``wsum`` is
    ``None``, or with ``want_sums`` (the K3ws leg) the f32 sums of ``w*x``
    per slot.  ``full_bracket`` (every bracket holds every element) lets a
    first sweep of identical ladders bin the one ladder
    (:func:`one_ladder`: the same bits)."""
    key = "wcp_histogram_multi" + ("_sums" if want_sums else "")
    if not want_sums and edges.dim() == 2 and edges.shape[0] > 1 \
            and one_ladder(edges, full_bracket):
        cnt, part = _whist_multi(x, w, edges[:1], key)
        k = edges.shape[0]
        return (cnt.expand(k, -1).contiguous(),
                part[:, 0].expand(k, -1).contiguous(), None)
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
