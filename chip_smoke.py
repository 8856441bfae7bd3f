"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

or, to time this tree against another one (a parent commit unpacked with
``git archive`` into a git-ignored directory), each in its own process,
in turns (other, this, this, other, ...):

    python3 chip_smoke.py --compare build/parent

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
   ``sum_blocks.cu``, which sums the block partials of K2, K4 and the
   histogram legs with f32 rows, against the f64 sum at the shapes of the
   main path's launches (within its f32 chain; two launches and each
   column alone bit for bit); ``row_sums`` (the rows path's per-row sums,
   ``sum_blocks.cu``) against its plain version: masses bit for bit with
   integer weights, dense sums within their chain of f64, each row alone
   the same bits as in its batch;
2. K1 (row histogram) against its plain version on the card, counts equal
   bit for bit, at the main path's (1, 2^27) and (64, 2^20) and at an n
   that is a multiple of no grid stride (``K1_SHAPES``), f32 and bf16,
   with ±inf, NaN, signed zeros and denormals in the data and full-range,
   data-scale, narrow, duplicated-edge and denormal edge ladders, the
   first sweep's ladder over each row's finite range (every element but
   the SPECIALS in the bracket), and at ``N_ODD`` (its row starting off a
   16-byte boundary) two 8192-bin ladders; each in every design the call
   can take (lane-private with ``full_bracket``, the shared histogram);
   two launches identical;
3. K2 (row partials) against its plain version at those shapes and the
   auto cp leg's n = 50,000 (``K2_SHAPES``): counts equal, NaN patterns
   equal, sums within ``SUM_RTOL``;
4. K3 (shared-x multi-ladder histogram) against its plain version, counts
   bit for bit: n = 2^27 with K = 16 identical first-sweep ladders and
   with the five ladder kinds cycled over K = 16, n = ``N_ODD`` with
   K = 64 (four groups of 16 ladders), with K = 3 at 8192 bins (one ladder
   per block, past 48 KB of shared memory), 16 staggered ladders, and
   with K = 1 through ``cp_histogram``; the first sweep's identical
   ladders in both designs (K1's lane kernel on the one ladder with
   ``full_bracket``, K3's buckets without);
5. K4 (shared-x multi-pivot partials) against its plain version at
   (2^27, 16), (50,000, 16), (``N_ODD``, 64) and (``N_ODD``, 17) with
   inf, -inf and NaN pivots (the kernel's general path), and K = 1
   through ``cp_partials``: counts equal, sums within ``SUM_RTOL``; on
   each, two launches, a permutation of the pivots and every pivot alone
   (K = 1 and K2's row kernel) give the same bits, sums included;
6. the port's main paths at full size through their public entry points,
   each value checked against ``torch.sort`` on the card and the launch
   counts of each run read from zero: ``median`` of n = 2^27 f32 (binned
   leg, K1), ``order_statistic`` with ``method='cp'`` at 2^27 and auto at
   n = 50,000 (cp leg, K2), ``select_rows`` on (64, 2^20) with per-row k,
   a bf16 median; then shared-x multi-k: ``quantiles`` at 16 levels of
   n = 2^27 f32 and bf16 (binned leg, K3, one launch per sweep for all
   16 targets), ``multi_order_statistic(method='cp')`` at 2^27 and
   ``quantiles`` auto at n = 50,000 (cp leg, K4);
7. timings with CUDA events (medians of repeated runs after warm-up): each
   kernel, its plain version and its bound (bytes at 3.35 TB/s, or f32
   lane operations at the card's lane rate, ``lane_ops_per_s``), K4 at
   K in ``KS_SWEEP``; the 16-target ``multi_order_statistic(method='cp')``
   with its loop and finalize; the median, ``select_rows``
   and the 16 quantiles end to end with ``torch.kthvalue`` / ``torch.sort``
   (plus a gather) as yardsticks that the port never calls, and the 16
   quantiles also against 16 separate ``order_statistic`` calls; a
   breakdown of the 2^27 median and of the 16 quantiles;
8. the weighted legs K1w-K4w against their plain versions on the card, at
   the K1-K4 shapes above (8192 bins and K = 64 included), x and w each
   f32 and bf16, with the SPECIALS in the data: counts and masses bit for
   bit with integer weights whose totals stay below 2^24 (zero weights
   and whole zero-mass slots included); with dense random weights the
   masses within ``f32_chain`` * 2^-24 of the f64 plain version (the
   longest chain of f32 additions in the kernel); each weighted kernel
   launched twice on the same dense input gives identical bits; K1w also
   at the first sweep's ladder and at 8192 bins (the grouped design), and
   at n = 2^23 + 3 (1024 blocks) with dense weights each of 16 rows alone
   gives the same bits as its entry in the batch; K3w at that n with dense
   weights: each of 16 ladders alone equals its entry among the 16, and a
   permutation of the 16 changes nothing, on every set of
   ``identity_ladders`` (identical, disjoint narrow, nested and disjoint
   cycled, partly overlapping staggered, fully overlapping polished
   ladders); K4w also
   at (``N_ODD``, 17) with non-finite pivots, with the launch identities
   of phase 5 (against K2w) on integer and dense weights;
9. the weighted paths at full size through their public entry points, the
   launch counts of each run read from zero and only the weighted kernels
   allowed to launch: ``weighted_median`` of n = 2^27 f32 with 0/1 weights
   at density 1/16 (K1w; every mass exact, so the value equals a
   ``torch.sort`` + f64 cumulative-mass oracle bit for bit), the same with
   dense weights (checked by a mass interval of stated width), a bf16-x
   median, ``weighted_select_rows`` on (64, 2^20) with integer weights
   (and, with dense weights and on ``select_rows(method='cp')``, each row
   alone and the 64 permuted the same bits as the batch in every field),
   ``weighted_quantiles`` at 16 levels (K3w, one launch per sweep),
   ``weighted_order_statistic(method='cp')`` at 2^27 and auto at n =
   50,000 (K2w), ``weighted_multi_order_statistic(method='cp')`` at 16
   targets (K4w);
10. weighted timings: each weighted kernel, its plain version and its
   bound, K4w at K in ``KS_SWEEP``; the weighted median, rows batch and 16
   quantiles end to end with a breakdown, against ``torch.sort`` + a
   gather of the weights + ``torch.cumsum`` + ``torch.searchsorted`` (the
   yardstick; the port never calls it); the 16-target
   ``weighted_multi_order_statistic(method='cp')`` with its loop and
   finalize; K4's and K4w's registers (ptxas) and SASS instructions per
   (element, pivot) (``cuobjdump``) in this run's build, and their issue
   bound.

11. the per-slot sums legs K1s, K1ws (``hist_batched.cu``) and K3s, K3ws
   (``hist_multi_sums.cu``, the sorted-tile design; ``hist_multi.cu``'s
   grouped design on ladders too wide for one a block) against their plain
   versions at the K1 and K3 shapes above (``N_ODD``, K = 64, 8192 bins,
   K = 2 at 12288 bins for the grouped design, and the K = 1 views
   included), x and w each f32 and bf16: counts, masses and sums bit for
   bit on integer data whose slot totals stay below 2^24, with ±inf, NaN
   and ±0 planted (NaN and inf slots equal with ``equal_nan``); on randn
   with the SPECIALS each slot sum within the leg's chain (``f32_chain``,
   or ``sorted_chain`` for the sorted-tile design) * 2^-24 of the f64
   plain version (relative to the slot's sum of |values|); two launches
   identical; K1s and K1ws also on the first sweeps the engine bins (the
   polished ladder, a warm tick's ``prior_edges`` ladder, at ``N_ODD`` the
   uniform one at 8192 bins), in both designs (lane columns with
   ``full_bracket``, grouped rows), and at n = 2^23 + 3 with dense weights
   each of 16 rows alone and the 16 permuted equal to the batch, bit for
   bit (``rows_alone_equal_batch``); at n = 2^23 + 3 (1024 blocks) with
   dense weights each of 16
   ladders alone, and the 16 permuted, equal their entries among 16, bit
   for bit, on K3s and K3ws, on five ladder sets (``identity_ladders``:
   the first sweep's identical ladders, the narrow ones, the five bracket
   kinds cycled, staggered ones, the polished first sweep's distinct
   ones);
12. ``method='binned_polish'`` at full size, each run's launch counts read
   from zero and only the sums legs allowed to launch (one per sweep):
   ``median`` of 2^27 f32 and bf16 (K1s), ``select_rows`` on (64, 2^20)
   (K1s), 16 ``quantiles`` of 2^27 (K3s), ``weighted_median`` of 2^27 with
   0/1 and with dense weights (K1ws), 16 ``weighted_quantiles`` (K3ws),
   each against ``torch.sort`` or the sort + f64 cumulative-mass oracle;
13. warm starts at full size: ``median(x, prior=cold)`` on unchanged x
   (1 sweep, EXACT_HIT), a ``QuantileTracker(0.5)`` over 8 ticks of a 2^27
   stream whose ticks each replace 2^-10 of the elements in place (every
   tick's value against ``torch.sort``, 1 sweep per tick after the first),
   ``reselect`` with 0/1 weights on the same stream, and
   ``order_statistic(method='cp', prior=cold)`` at n = 50,000 (1 pass);
14. timings: each sums leg against its bound, its no-sums twin and its
   plain version, on the polished first sweep too; K1s and K1ws on the
   polished, uniform and narrow ladders at (1, 2^27) and (64, 2^20) in
   each design, and K1 on a warm tick's ladder (``rows_sums_times``); the
   polished median, rows batch, 16 quantiles and 16 weighted quantiles
   against their 'binned' twins with sweeps per answer, the multi-k ones
   with loop and finalize; one warm tracker tick against a cold median on
   the same tick's data, each with a stats / loop / finalize breakdown;
   the build report of ``hist_multi_sums.cu`` (registers, spills, shared
   bytes, blocks per SM);
15. segmented selection at full size, plain torch on the card (no kernel
   may launch; counts read from zero around each run):
   ``segmented_quantiles`` of |g| at q = 0.99 and 0.5, auto and
   'binned_polish', over the 14 leaves of two phi3-mini decoder layers'
   gradients (``phi3_grads``, 226,504,704 f32), each threshold against
   ``torch.sort`` of its leaf; ``segmented_order_statistic`` on 2^27
   elements in 16 interleaved segments against a per-segment sort, each
   segment alone equal to its entry among the 16 in every field and two
   runs the same bits; the auto cp leg at 50,000 elements in 8 segments;
16. the robust consumers at full size (only the rows kernels K1, K1w, K2,
   K2w and their sums legs may launch, with ``row_sums`` and
   ``sum_blocks``): ``lts_fit`` on (2^20, 8) with 30% outliers, 64
   starts, 10 steps, warm and cold the same bits, the objective within
   1e-5 of the f64 sum of the h smallest r^2 by sort, the truth
   recovered; ``lms_fit`` with 256 starts, its objective the sorted median
   of the best start's r^2 bit for bit; ``knn_predict`` on (2^20, 16)
   integer coordinates with 256 queries, k = 32, each cutoff the row's
   sorted k-th distance and the predictions those of a ``torch.topk``
   twin; ``irls_fit`` on (2^24, 8), Huber and Tukey, 30 iterations, warm
   against cold, each final scale inside the mass interval of its last
   weighted median; ``theil_sen_fit`` at 2^20 with 2^27 pairs (128
   offsets), 'sen' and 'uniform', the slope inside the mass interval and
   the intercept against a sort; ``clip_by_quantile`` per leaf (against a
   sort of each leaf) and global (its rank within 1e-3 of q), and
   ``hist_quantile`` within a bin, on the phase-15 pytree;
17. timings: each fit end to end and the ms of its selections, against a
   twin that replaces each selection with ``torch.sort`` /
   ``torch.topk`` / sort + cumsum + searchsorted (the port never calls
   them); the segmented solve at 2^27 x 16 (layout, stats, one sweep,
   loop, finalize) against the bound of one read of x and seg.  Phases
   15-17's record is also written to chiprun_out/robust.json;
18. the distributed layer (``repro_torch.core.distributed``): 4 gloo ranks
   on the one card (this script, ``--dist-rank``; ``file://`` init; each
   shard a CUDA tensor; the kernels built before they start), each case's
   launch counts read from zero on every rank and only the path's kernel
   allowed (once a round, with ``sum_blocks`` / ``row_sums`` where its leg
   has f32 partials): ``sharded_median`` of 2^27 f32 randn ('binned', K3
   at one ladder; 'binned_polish', K3s; 'cp', K4), ``sharded_quantile``
   0.9, a warm re-selection (1 round, the cold bits),
   ``sharded_weighted_median`` with 0/1 weights (K3w, K3ws, K4w) and dense
   weights (a mass interval), ``sharded_quantiles`` at 16 levels (K3, K3s,
   K4 at K = 16) and the weighted twins (K3w, K3ws, K4w), the K = 8
   deciles at n = 2^20 with nbins 512 and cap_local 4096 in 1 round (both
   measures); rank 0 holds each value against ``torch.sort`` of the whole
   array (or the sort + f64 cumulative-mass oracle) and the local engine;
   ``robust_aggregate`` over 4 replicas of phi3-mini's attention output
   projection (3072 x 3072) and two RMSNorm scales, one replica poisoned
   at 1e6: 'mean', 'median' (auto, 'cp', 'binned') and 'trimmed', each
   against a sort of the replicas; every rank's fields the same bits;
   timings (host clock around synchronized calls, medians of 5 after a
   warm-up) with a breakdown into local passes and collectives, the local
   median on one rank, K3s/K3ws at one ladder in both designs; then one
   NCCL rank's ``sharded_median``.  Written to
   chiprun_out/distributed.json;
19. LM serving (``repro_torch.models`` in plain torch, f32, no TF32):
   phi3-mini-3.8b at full width and depth (3,821,079,552 parameters, drawn
   from a seeded CUDA generator) served by the launcher's loop
   (``launch.serve.serve``, B = 4, prompt 16, gen 16), its per-token
   latency p50 / p99 by ``median`` / ``quantile`` on the card with the
   launch counts read from zero around the serve call: ``row_sums`` and
   ``sum_blocks`` once an answer, K2 0 times (the ~29 latencies fit the
   selection cap, so the cp loop runs no pass), no histogram kernel; each
   value equal to ``torch.sort`` of the same latencies, none
   NOT_CONVERGED; ``row_sums``, ``sum_blocks`` and K2 at the path's shape
   (1, 29) against their plain versions; a second, longer window (prompt
   1024, gen 128: a cache of 1152 slots, ~1150 timed steps) for the
   percentiles' record; the same weights cut to 2 layers on the card and
   through the port on the CPU, 4 decode steps (logits within
   ``CARD_CPU_TOL`` of the largest |logit|, greedy tokens equal where the
   top-2 margin is wider than twice that); the decode logits of a
   64-token prompt against the prefill step's (``DECODE_TOL``), for
   phi3-mini and for gemma2-2b (2,614,222,080 parameters: ring caches,
   softcaps, tied embeddings, vocab 256000), which is served the same way;
   one timed phi3-mini prefill of 4 x 1536 tokens; ms per decoded token
   against the bytes bound of reading the parameters once, peak memory.
   Each model is freed before the next.  Written to chiprun_out/serve.json;
20. LM training (``repro_torch.train``, ``optim``, ``data``,
   ``checkpoint``; plain torch, f32, no TF32): phi3-mini's first 16 of 32
   layers at full width (2,009,041,920 parameters from a seeded CUDA
   generator), ``remat='full'``, AdamW with an f32 master, the quantile
   clip (q 0.99, 12 cutting-plane passes), B = 4, S = 1024 from
   ``SyntheticPipeline``: one warm-up step and 3 timed steps through
   ``fit`` (no checkpoints), the losses finite and falling; ``fit``'s own
   p50 / p99 of the step times (by ``median`` / ``quantile`` on the card)
   equal to ``torch.sort``'s, their launches counted from zero around the
   timed ``fit`` and held exactly as phase 19's (``row_sums`` 2,
   ``sum_blocks`` 2 + cp passes, K2 once a cp pass), and ``row_sums``,
   ``sum_blocks`` and K2 held against their plain versions on the
   (1, 3) row of step times (``served_kernels``); tokens/s against the
   operations bound (``train_flops``, 67 TFLOP/s); the gradients, the
   clip and the optimizer timed apart with CUDA events; peak memory; the
   same step twice from one state (bits of the loss and ``clip_thr``
   recorded, not required); the 2-layer cut card against CPU, 2 steps
   (loss within ``TRAIN_LOSS_RTOL``, ``clip_thr`` within
   ``TRAIN_THR_RTOL``, every parameter within 0.05 lr a step and all but
   2% within 1e-4 lr); a reduced config's ``fit`` with a
   ``CheckpointManager`` in a temporary directory stopped after step 4 of
   8 and resumed: the same losses and weights as an uninterrupted run, bit
   for bit.  Written to chiprun_out/train.json.

Every pass with f32 block partials (K2, K4, and the histogram legs with
rows: K1w, K1s, K1ws, K3w, K3s, K3ws) sums them with one ``sum_blocks``
launch, and the main paths' launch counts are held to that.

The line before the last two is ``{"kernels": [...]}`` (all twelve kernel
legs: K1-K4, their weighted legs K1w-K4w, and the sums legs K1s, K1ws,
K3s, K3ws; and ``sum_blocks``, the block sums of every leg with f32
partials; K1's, K1w's, K1s's and K1ws's rows with first- and narrow-sweep
times (K1s/K1ws also polished), their registers, shared memory and blocks
per SM); then the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import copy
import ctypes
import dataclasses
import functools
import inspect
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 bandwidth.  The f32 work of these kernels
# (subtracts, compares, selects, adds and multiplies, no FMA) runs one
# operation per lane and clock: 4 schedulers x 32 lanes per SM, at the
# card's maximum SM clock (`lane_ops_per_s`, ~33.5e12/s on an H100 SXM;
# the data sheet's 67e12 counts an FMA as two)
HBM_BYTES_PER_S = 3.35e12
LANES_PER_SM = 128
# K2 sums: f32 same-sign terms reduced in another order than torch.sum.
# A thread adds at most n / (nblk * 256) = 512 terms in sequence at 2^27,
# so either order is within ~512 * 2^-24 = 3e-5 relative of the exact sum.
SUM_RTOL = 1e-4
DEVICE = "cuda"
N_BIG = 1 << 27
ROWS, N_ROW = 64, 1 << 20
N_SMALL = 50_000      # the auto (cp) leg of the main path
N_ODD = (1 << 20) + 3  # a multiple of no grid stride: the tail loops run
# (rows, n, seed) of each kernel check: the main path's shapes and N_ODD
K1_SHAPES = ((1, N_BIG, 1), (ROWS, N_ROW, 2), (1, N_ODD, 11))
K2_SHAPES = ((1, N_BIG, 3), (ROWS, N_ROW, 4), (1, N_SMALL, 12),
             (1, N_ODD, 13))
# the shared-x multi-k path: 16 quantile levels (1/17 .. 16/17)
QS16 = np.arange(1, 17) / 17
# K4 and K4w timed at these numbers of pivots (evenly spaced quantiles)
KS_SWEEP = (1, 4, 16, 64)
# --compare: runs per tree, in turns (other, this, this, other, other,
# this)
COMPARE_ROUNDS = 3
# f32 lane operations per (element, pivot) that K4 cannot do without: a
# subtract, two compares (each also gives its complement), two sum adds
# and two count adds; K4w a multiply and two more sum adds
K4_OPS, K4W_OPS = 7, 10
SPECIALS = [float("inf"), float("-inf"), float("nan"), 0.0, -0.0, 1e-44,
            -1e-44, 1e-39, -3e-39, 3e38, -3e38]


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int, rounds: int = 5, warmup: int = 2) -> float:
    """Median over ``rounds`` of the mean per-call time of ``reps`` calls,
    timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def graph_ms(fn, reps: int = 20, rounds: int = 7) -> float:
    """Median over ``rounds`` of the device time per call of ``reps``
    calls captured in one CUDA graph: the time on the card without the
    host's launch overhead (for kernels of a few microseconds, which
    back-to-back launches from the host would pace)."""
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    for _ in range(3):
        graph.replay()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def gen(seed: int):
    return torch.Generator(device=DEVICE).manual_seed(seed)


def special_data(rows: int, n: int, seed: int) -> torch.Tensor:
    """randn rows with the SPECIALS planted at random positions."""
    g = gen(seed)
    x = torch.randn((rows, n), generator=g, device=DEVICE)
    sp = torch.tensor(SPECIALS, device=DEVICE)
    reps = 6
    pos = torch.randint(0, n, (rows, reps * sp.numel()), generator=g,
                        device=DEVICE)
    x.scatter_(1, pos, sp.repeat(reps).expand(rows, -1).contiguous())
    return x


def edge_ladders(ref, kinds, nbins: int) -> torch.Tensor:
    """One realized ladder per entry of ``kinds`` (bracket (lo, hi))."""
    lo = torch.tensor([k[0] for k in kinds], dtype=torch.float32,
                      device=DEVICE)
    hi = torch.tensor([k[1] for k in kinds], dtype=torch.float32,
                      device=DEVICE)
    return ref.bin_edges(lo, hi, nbins).contiguous()


def bracket_kinds():
    one_up = float(np.nextafter(np.float32(0.25), np.float32(1.0)))
    return [(-3e38, 3e38),          # full range: width overflows f32
            (-2.0, 2.0),            # data scale: a first sweep
            (-1e-3, 2e-3),          # narrow: a later sweep
            (0.25, one_up),         # one ulp wide: duplicated edges
            (-1e-40, 1e-40)]        # denormal bracket


def first_sweep_edges(ref, x: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per row of ``x`` (B, n), the first sweep's ladder: [min, max] of
    the row's values of magnitude below 1e30 (so every element but the
    SPECIALS lies in the bracket)."""
    xf = x.float()
    ok = xf.abs() < 1e30
    lo = torch.where(ok, xf, float("inf")).amin(dim=1)
    hi = torch.where(ok, xf, float("-inf")).amax(dim=1)
    return ref.bin_edges(lo, hi, nbins).contiguous()


def full_kw(cpo, full: bool = True) -> dict:
    """The row histogram wrappers' ``full_bracket`` keyword (the first
    sweep: every element in the bracket), for a tree whose wrappers take
    it; a tree without it has one design per call."""
    params = inspect.signature(cpo.cp_histogram_batched).parameters
    return {"full_bracket": full} if "full_bracket" in params else {}


def k3_kw(cpo, full: bool = True, fn=None) -> dict:
    """The ``full_bracket`` keyword of K3's wrapper (or ``fn``, K3w's):
    every bracket holds every element, the first sweep, where identical
    ladders bin one ladder; for a tree whose wrapper takes it."""
    params = inspect.signature(fn or cpo.cp_histogram_multi).parameters
    return {"full_bracket": full} if "full_bracket" in params else {}


def k1_designs(cpo, nedges: int, nrows: int, n: int, sums: bool = False):
    """The ``full_bracket`` values that reach distinct designs of K1
    (``nrows`` 0), K1w (1), K1s (1, ``sums``) or K1ws (2) at this call."""
    if not full_kw(cpo):
        return [False]
    kw = ({"sums": sums} if "sums" in inspect.signature(
        cpo.hist_rows_layout).parameters else {})
    lay = {f: cpo.hist_rows_layout(nedges, nrows, n, f, **kw)
           for f in (False, True)}
    return [False] if lay[True] == lay[False] else [False, True]


def k1_ladders(ref, x: torch.Tensor, n: int):
    """(label, edges) of the K1 and K1w checks on ``x`` (B, n): the five
    bracket kinds (one per row for a batch, each in turn for B = 1), the
    first sweep's ladder, and at ``N_ODD`` two 8192-bin ladders (data
    scale and first sweep) past the lane-private tables' width."""
    kinds = bracket_kinds()
    rows = x.shape[0]
    ladders = ([[kinds[i % len(kinds)] for i in range(rows)]]
               if rows > 1 else [[kind] for kind in kinds])
    out = [(str(ladder[:5]), edge_ladders(ref, ladder, 128))
           for ladder in ladders]
    out.append(("first sweep", first_sweep_edges(ref, x, 128)))
    if n == N_ODD:
        out.append(("data scale, 8192 bins",
                    edge_ladders(ref, [kinds[1]] * rows, 8192)))
        out.append(("first sweep, 8192 bins", first_sweep_edges(ref, x, 8192)))
    return out


def check_k1(cpo, ref) -> dict:
    """K1 counts against the plain version; returns the largest
    |kernel - plain| count difference (it raises unless that is 0)."""
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n, seed in K1_SHAPES:
            x = special_data(rows, n, seed).to(dtype)
            if n == N_ODD:  # rows off a 16-byte boundary (K1's head path)
                buf = torch.empty(rows * n + 3, dtype=dtype, device=DEVICE)
                x = buf[3:].view(rows, n).copy_(x)
            for label, e in k1_ladders(ref, x, n):
                want, _ = ref.cp_histogram_batched_ref(x, e, want_sums=False)
                for full in k1_designs(cpo, e.shape[1], 0, n):
                    kw = full_kw(cpo, full)
                    got, _ = cpo.cp_histogram_batched(x, e, **kw)
                    torch.cuda.synchronize()
                    worst = max(worst, int((got - want).abs().max()))
                    if not torch.equal(got, want):
                        raise AssertionError(
                            f"K1 counts differ from the plain version: "
                            f"({rows}, {n}) {dtype} {label} full={full}")
                    if not torch.equal(
                            got, cpo.cp_histogram_batched(x, e, **kw)[0]):
                        raise AssertionError(
                            f"K1: two launches differ: ({rows}, {n}) "
                            f"{dtype} {label} full={full}")
                    assert torch.all(got.sum(dim=1) == n)
            del x
    log(f"K1 hist_batched == plain version bit for bit at (rows, n) "
        f"{[s[:2] for s in K1_SHAPES]}, 5 edge ladders and the first "
        f"sweep's (128 bins), 8192-bin ladders at n={N_ODD}, f32 and bf16, "
        f"with inf/NaN/denormals, in each design the call can take (lane-"
        f"private with full_bracket, shared histogram); two launches "
        f"identical")
    return {"max_abs_err": float(worst)}


def check_k2(cpo, ref) -> dict:
    worst_abs, worst_rel = 0.0, 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n, seed in K2_SHAPES:
            for special in (True, False):
                if special:
                    x = special_data(rows, n, seed)
                else:
                    x = torch.randn((rows, n), generator=gen(seed + 10),
                                    device=DEVICE)
                x = x.to(dtype)
                pivots = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5],
                                      device=DEVICE)
                y = pivots[torch.arange(rows, device=DEVICE) % pivots.numel()]
                y[-1] = x[-1, 12345].float()  # a pivot on a data value
                got = cpo.cp_partials_batched(x, y)
                want = ref.cp_partials_batched_ref(x, y)
                torch.cuda.synchronize()
                for g, w in zip(got[2:], want[2:]):
                    if not torch.equal(g, w):
                        raise AssertionError(f"K2 counts differ: {rows}x{n} "
                                             f"{dtype} special={special}")
                for g, w in zip(got[:2], want[:2]):
                    torch.testing.assert_close(g, w, rtol=SUM_RTOL, atol=0,
                                               equal_nan=True)
                    fin = torch.isfinite(w) & (w != 0)
                    if bool(fin.any()):
                        err = (g - w).abs()[fin]
                        worst_abs = max(worst_abs, float(err.max()))
                        worst_rel = max(worst_rel, float(
                            (err / w.abs()[fin]).max()))
                del x
    log(f"K2 fg_batched == plain version: counts bit for bit, sums within "
        f"rtol {SUM_RTOL} (worst {worst_rel:.3g}), (rows, n) "
        f"{[s[:2] for s in K2_SHAPES]}, f32 and bf16, with and without "
        f"inf/NaN/denormals")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel}


def check_k3(cpo, ref) -> dict:
    """K3 counts against the plain version; returns the largest
    |kernel - plain| count difference (it raises unless that is 0)."""
    kinds = bracket_kinds()
    worst = 0

    def compare(got, want, label):
        nonlocal worst
        torch.cuda.synchronize()
        worst = max(worst, int((got - want).abs().max()))
        if not torch.equal(got, want):
            raise AssertionError(f"K3 counts differ from the plain version: "
                                 f"{label}")

    for dtype in (torch.float32, torch.bfloat16):
        x = special_data(1, N_BIG, 21)[0].to(dtype)
        for label, e in (
                ("16 identical", edge_ladders(ref, [kinds[1]] * 16, 128)),
                ("5 kinds cycled over 16",
                 edge_ladders(ref, [kinds[j % 5] for j in range(16)], 128)),
                ("16 identical first-sweep",
                 first_sweep_edges(ref, x[None], 128).expand(16, -1)
                 .contiguous())):
            want, _ = ref.cp_histogram_multi_ref(x, e, want_sums=False)
            for full in (False, True):  # K3's kernel, K1's on one ladder
                got, _ = cpo.cp_histogram_multi(x, e, **k3_kw(cpo, full))
                compare(got, want, f"n=2^27 {dtype} {label} full={full}")
                assert torch.all(got.sum(dim=1) == N_BIG)
        del x
        x = special_data(1, N_ODD, 22)[0].to(dtype)
        for k, nbins in ((64, 128), (3, 8192)):
            e = edge_ladders(ref, [kinds[j % 5] for j in range(k)], nbins)
            got, _ = cpo.cp_histogram_multi(x, e)
            want, _ = ref.cp_histogram_multi_ref(x, e, want_sums=False)
            compare(got, want, f"n={N_ODD} {dtype} K={k} nbins={nbins}")
        for label, e in (("16 staggered", edge_ladders(
                ref, [(-2.0 + 0.25 * j, -1.0 + 0.25 * j) for j in range(16)],
                128)), ("16 identical first-sweep", first_sweep_edges(
                    ref, x[None], 128).expand(16, -1).contiguous())):
            want, _ = ref.cp_histogram_multi_ref(x, e, want_sums=False)
            for full in (False, True):
                got, _ = cpo.cp_histogram_multi(x, e, **k3_kw(cpo, full))
                compare(got, want, f"n={N_ODD} {dtype} {label} full={full}")
        for kind in kinds:
            e1 = edge_ladders(ref, [kind], 128)[0]
            got, _ = cpo.cp_histogram(x, e1)
            want, _ = ref.cp_histogram_ref(x, e1, want_sums=False)
            compare(got, want, f"n={N_ODD} {dtype} K=1 {kind}")
    log(f"K3 hist_multi == plain version bit for bit at n=2^27 K=16 "
        f"(identical, cycled and first-sweep ladders, each with and without "
        f"full_bracket), n={N_ODD} K=64, K=3 at 8192 bins, "
        f"16 staggered ladders and K=1 (cp_histogram), f32 and bf16, with "
        f"inf/NaN/denormals")
    return {"max_abs_err": float(worst)}


# pivots that are not finite: they take K4's and K4w's general path
NONFINITE = [float("inf"), float("-inf"), float("nan")]


def pivot_identities(name, multi, one, rows, y, label) -> None:
    """A pivot's partials do not depend on its launch: ``multi(y)`` twice,
    on a permutation of ``y``, and each pivot alone through the K=1 view
    ``one`` and through the row kernel ``rows`` (K2 or K2w) give the same
    bits, sums included."""
    got = multi(y)
    if not all(same_bits(a, b) for a, b in zip(got, multi(y))):
        raise AssertionError(f"{name}: two launches differ: {label}")
    perm = torch.randperm(y.numel(), generator=gen(y.numel()), device=DEVICE)
    if not all(same_bits(a[perm], b) for a, b in zip(got, multi(y[perm]))):
        raise AssertionError(f"{name}: permuted pivots differ: {label}")
    for j in range(y.numel()):
        for view, vname in ((one, "K=1"), (rows, "row kernel")):
            alone = view(y[j:j + 1])
            if not all(same_bits(a[j:j + 1], b.reshape(1))
                       for a, b in zip(got, alone)):
                raise AssertionError(f"{name}: pivot {j} alone ({vname}) "
                                     f"differs from its entry: {label}")


def check_k4(cpo, ref) -> dict:
    worst_abs, worst_rel = 0.0, 0.0

    def compare(got, want, label):
        nonlocal worst_abs, worst_rel
        torch.cuda.synchronize()
        for g, w in zip(got[2:], want[2:]):
            if not torch.equal(g, w):
                raise AssertionError(f"K4 counts differ: {label}")
        for g, w in zip(got[:2], want[:2]):
            torch.testing.assert_close(g, w, rtol=SUM_RTOL, atol=0,
                                       equal_nan=True)
            fin = torch.isfinite(w) & (w != 0)
            if bool(fin.any()):
                err = (g - w).abs()[fin]
                worst_abs = max(worst_abs, float(err.max()))
                worst_rel = max(worst_rel, float((err / w.abs()[fin]).max()))

    pivots = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5, -2.0, 0.7],
                          device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        for n, k, seed in ((N_BIG, 16, 23), (N_SMALL, 16, 24),
                           (N_ODD, 64, 25), (N_ODD, 17, 26)):
            for special in (True, False):
                if special:
                    x = special_data(1, n, seed)[0]
                else:
                    x = torch.randn(n, generator=gen(seed + 10),
                                    device=DEVICE)
                x = x.to(dtype)
                y = pivots[torch.arange(k, device=DEVICE) % pivots.numel()]
                y[-1] = x[12345].float()  # a pivot on a data value
                if k == 17:  # the first group of 16 holds non-finite pivots
                    y[:3] = torch.tensor(NONFINITE, device=DEVICE)
                label = f"n={n} K={k} {dtype} special={special}"
                compare(cpo.cp_partials_multi(x, y),
                        ref.cp_partials_multi_ref(x, y), label)
                got = cpo.cp_partials(x, y[-1])
                compare([g[None] for g in got],
                        ref.cp_partials_multi_ref(x, y[-1:]),
                        label + " K=1")
                pivot_identities(
                    "K4", lambda yy: cpo.cp_partials_multi(x, yy),
                    lambda yy: cpo.cp_partials(x, yy[0]),
                    lambda yy: cpo.cp_partials_batched(x[None], yy),
                    y, label)
                del x
    log(f"K4 fg_multi == plain version: counts bit for bit, sums within "
        f"rtol {SUM_RTOL} (worst {worst_rel:.3g}), (n, K) (2^27, 16), "
        f"({N_SMALL}, 16), ({N_ODD}, 64), ({N_ODD}, 17) with inf/-inf/NaN "
        f"pivots, and K=1 (cp_partials), f32 and bf16, with and without "
        f"inf/NaN/denormals; two launches, permuted pivots and each pivot "
        f"alone (K=1 and K2) bit for bit")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel}


def sum_blocks_shapes(cpo):
    """(outer, nblk, inner) of the block partials handed to
    ``sum_blocks``: K4 and K4w at 16 pivots of 2^27 and K4 of N_SMALL (the
    multi-k main path), K2 at one row of 2^27 and of N_SMALL and K2w at one
    row of 2^27 (the scalar and weighted main paths), K2 on the rows batch
    (64, 2^20); K1w at one row of 2^27 and on the rows batch, and K3w at 16
    ladders of 2^27 (128 bins, 130 slots)."""
    big, small = cpo.fg_blocks(N_BIG), cpo.fg_blocks(N_SMALL)
    rows = cpo.fg_blocks(N_ROW)
    return ((1, big, 16 * 2), (1, big, 16 * 4), (1, small, 16 * 2),
            (1, big, 2), (1, small, 2), (ROWS, rows, 2), (1, big, 4),
            (1, big, 130), (ROWS, rows, 130), (1, big, 16 * 130))


def check_sum_blocks(cpo) -> dict:
    """``sum_blocks`` against ``torch.sum`` (the call it took the place of)
    and the f64 sum on non-negative partials, as K2's and K4's are: within
    the f32 chain of the exact sum (a lane's serial adds, then 5 shuffle
    levels); two launches, and each column summed alone, the same bits."""
    worst_abs, worst_rel = 0.0, 0.0
    for i, shape in enumerate(sum_blocks_shapes(cpo)):
        part = torch.rand(shape, generator=gen(200 + i), device=DEVICE) * 1e3
        got = cpo._sum_blocks(part)
        exact = part.double().sum(1)
        err = (got.double() - exact).abs()
        worst_abs = max(worst_abs, float(err.max()))
        rel = float((err / exact).max())
        worst_rel = max(worst_rel, rel)
        chain = -(-shape[1] // 32) + 5
        if rel > chain * 2.0 ** -24:
            raise AssertionError(f"sum_blocks {shape}: relative error {rel} "
                                 f"past its chain of {chain} adds")
        if not same_bits(got, cpo._sum_blocks(part)):
            raise AssertionError(f"sum_blocks {shape}: two launches differ")
        for j in range(0, shape[2], max(1, shape[2] // 4)):
            alone = cpo._sum_blocks(part[:, :, j:j + 1].contiguous())
            if not same_bits(got[:, j:j + 1], alone):
                raise AssertionError(f"sum_blocks {shape}: column {j} alone "
                                     f"differs")
    log(f"sum_blocks == f64 sum within its f32 chain (worst relative "
        f"{worst_rel:.3g}) at {sum_blocks_shapes(cpo)}; two launches and "
        f"columns alone bit for bit")
    return {"max_abs_err": worst_abs, "max_rel_err": worst_rel}


ROW_MODES = (None, "mass", "moment", "le", "lt")  # None: the sum of x


def row_sums_call(cpo, x, w, c, mode):
    """``cpo.row_sums`` in ``mode`` (None: of ``x`` itself)."""
    return cpo.row_sums(x, None if mode is None else w, c, mode or "mass")


def row_sums_plain(ref, x, w, c, mode, dtype):
    return ref.row_sums_ref(x, None if mode is None else w, c,
                            mode or "mass", dtype=dtype)


def check_row_sums(cpo, ref) -> dict:
    """``row_sums`` (``csrc/sum_blocks.cu``, the rows path's per-row sums)
    against its plain version at the rows batch (64, 2^20), one row of
    2^27 and three of ``N_ODD``: with integer weights (every sum exact) on
    data with the SPECIALS, the masses (all, at or below and below a data
    value per row) bit for bit, x and w each f32 and bf16; on randn with
    dense weights each mode (the sum of x, w, w*x, and the two masses)
    within its f32 chain (``f32_chain``, and a rounding of each product)
    * 2^-24 of the f64 sum of the terms' magnitudes; each row alone, and
    two launches, the same bits."""
    chk = WeightedCheck("row_sums")
    for rows, n, seed in ((ROWS, N_ROW, 120), (1, N_BIG, 121), (3, N_ODD, 122)):
        x32, wi32, _ = weighted_inputs(rows, n, seed)
        c = x32[:, 12345].contiguous()  # a data value per row
        for xdt, wdt in WDTYPES:
            x, wi = x32.to(xdt), wi32.to(wdt)
            for mode in ("mass", "le", "lt"):
                chk.exact([cpo.row_sums(x, wi, c, mode)],
                          [row_sums_plain(ref, x, wi, c, mode,
                                          torch.float32)],
                          f"({rows}, {n}) {xdt} {wdt} {mode}")
        del x32, wi32, x, wi
        x = torch.randn((rows, n), generator=gen(seed + 3), device=DEVICE)
        wd = dense_weights((rows, n), seed + 4)
        c = x[:, 12345].contiguous()
        rtol = (f32_chain(cpo, n) + 1) * 2.0 ** -24
        for mode in ROW_MODES:
            got = row_sums_call(cpo, x, wd, c, mode)
            exact = row_sums_plain(ref, x.double(), wd.double(), c.double(),
                                   mode, torch.float64)
            scale = row_sums_plain(ref, x.double().abs(), wd.double(),
                                   c.double(), mode, torch.float64)
            if mode in ("le", "lt"):
                scale = exact
            err = (got.double() - exact).abs()
            if bool((err > rtol * scale).any()):
                raise AssertionError(f"row_sums {mode} ({rows}, {n}) outside "
                                     f"{rtol:.3g} of the f64 sums")
            chk.dense_rel = max(chk.dense_rel, float((err / scale).max()))
            chk.dense_bound = rtol
            chk.repeat(lambda: [row_sums_call(cpo, x, wd, c, mode)],
                       f"({rows}, {n}) {mode}")
            for r in range(min(rows, 16)):
                one = row_sums_call(cpo, x[r:r + 1], wd[r:r + 1],
                                    c[r:r + 1], mode)
                if not same_bits(one, got[r:r + 1]):
                    raise AssertionError(f"row_sums {mode}: row {r} alone "
                                         f"differs from its entry among "
                                         f"{rows}")
        del x, wd
    log(f"row_sums == plain version: masses bit for bit with integer "
        f"weights (x and w each f32 and bf16, with the SPECIALS), dense "
        f"sums within {chk.dense_bound:.3g} of f64 (worst "
        f"{chk.dense_rel:.3g}), rows alone and two launches the same bits, "
        f"at (64, 2^20), (1, 2^27), (3, {N_ODD})")
    return chk.result()


def same_results(a, b) -> bool:
    """Two SelectResults equal in every field, bit for bit."""
    return all(same_bits(u, v) if u.dtype == torch.float32 else
               torch.equal(u, v) for u, v in zip(a, b))


def rows_answers_alone_equal_batch(sel, check: bool = True) -> dict:
    """``weighted_select_rows`` on (64, 2^20) with dense weights ('binned'
    and 'binned_polish', whose first sweep runs K1ws) and
    ``select_rows(method='cp')`` (whose first pivot follows each row's
    mean): whether every ``SelectResult`` field of each row alone, and of
    the 64 rows permuted, equals its entry among the 64, bit for bit
    (raises if not, with ``check``)."""
    xr = torch.randn((ROWS, N_ROW), generator=gen(311), device=DEVICE)
    wr = dense_weights((ROWS, N_ROW), 312)
    wks = (torch.rand(ROWS, generator=gen(313), device=DEVICE)
           * wr.sum(dim=1)).contiguous()
    ks = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(314),
                       device=DEVICE)
    perm = torch.randperm(ROWS, generator=gen(315), device=DEVICE)
    every = torch.arange(ROWS, device=DEVICE)
    cases = {"weighted dense": lambda r: sel.weighted_select_rows(
                 xr[r], wr[r], wks[r]),
             "weighted dense polish": lambda r: sel.weighted_select_rows(
                 xr[r], wr[r], wks[r], method="binned_polish"),
             "counting cp": lambda r: sel.select_rows(xr[r], ks[r],
                                                      method="cp")}
    out = {}
    for label, run in cases.items():
        batch = run(every)
        same = same_results(run(perm), [f[perm] for f in batch])
        for r in range(ROWS):
            same &= same_results(run(every[r:r + 1]),
                                 [f[r:r + 1] for f in batch])
        out[label] = same
        if check and not same:
            raise AssertionError(f"{label}: a row alone or the rows permuted "
                                 f"differ from the batch of {ROWS}")
    return out


def drive(sel, cpo, label, fn, want, expect_kernel):
    """Run one main-path call with the launch counts read from zero."""
    cpo.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cpo.LAUNCHES)
    if not torch.equal(res.value.float(), want.float()):
        raise AssertionError(f"{label}: value differs from torch.sort")
    if bool((res.status == sel.NOT_CONVERGED).any()):
        raise AssertionError(f"{label}: NOT_CONVERGED")
    if launches[expect_kernel] == 0:
        raise AssertionError(f"{label}: {expect_kernel} never launched")
    iters = res.iters.reshape(-1)
    log(f"{label}: iters {sorted(set(iters.tolist()))[:8]} status "
        f"{sorted(set(res.status.reshape(-1).tolist()))} launches "
        f"{launches} first call {wall * 1e3:.1f} ms")
    return launches, res


def main_path(sel, cpo) -> dict:
    total = dict.fromkeys(cpo.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    x = torch.randn(N_BIG, generator=gen(5), device=DEVICE)
    xs = torch.sort(x).values
    k_med = (N_BIG + 1) // 2
    launches, res = drive(sel, cpo, "median n=2^27 f32 (binned)",
                          lambda: sel.median(x), xs[k_med - 1],
                          "cp_histogram_batched")
    assert launches["cp_histogram_batched"] == int(res.iters)
    assert launches["cp_partials_batched"] == 0
    add(launches)

    k_cp = N_BIG // 3
    launches, res = drive(sel, cpo, "order_statistic n=2^27 method=cp",
                          lambda: sel.order_statistic(x, k_cp, method="cp"),
                          xs[k_cp - 1], "cp_partials_batched")
    assert launches["cp_partials_batched"] == int(res.iters)
    add(launches)

    xsmall = x[:N_SMALL].contiguous()
    launches, res = drive(sel, cpo, f"median n={N_SMALL} auto (cp)",
                          lambda: sel.median(xsmall),
                          torch.sort(xsmall).values[(N_SMALL + 1) // 2 - 1],
                          "cp_partials_batched")
    add(launches)

    xb = x.to(torch.bfloat16)
    launches, res = drive(sel, cpo, "median n=2^27 bf16 (binned)",
                          lambda: sel.median(xb),
                          torch.sort(xb).values[k_med - 1],
                          "cp_histogram_batched")
    add(launches)
    del xs, xb

    xr = torch.randn((ROWS, N_ROW), generator=gen(6), device=DEVICE)
    ks = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(7),
                       device=DEVICE)
    want = torch.gather(torch.sort(xr, dim=1).values, 1,
                        (ks - 1)[:, None])[:, 0]
    launches, res = drive(sel, cpo, "select_rows (64, 2^20) per-row k",
                          lambda: sel.select_rows(xr, ks), want,
                          "cp_histogram_batched")
    add(launches)
    return total


def multi_k_path(sel, cpo) -> dict:
    """Shared-x multi-k at full size: 16 quantile levels of one array."""
    total = dict.fromkeys(cpo.LAUNCHES, 0)

    def add(launches, kernel, res):
        # one launch per sweep or pass for ALL targets, and no row kernel
        assert launches[kernel] == int(res.iters.max()), (launches, res.iters)
        assert launches["cp_histogram_batched"] == 0
        assert launches["cp_partials_batched"] == 0
        for k, v in launches.items():
            total[k] += v

    x = torch.randn(N_BIG, generator=gen(31), device=DEVICE)
    xs = torch.sort(x).values
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    want = xs[ks.long() - 1]
    launches, res = drive(sel, cpo, "quantiles K=16 n=2^27 f32 (binned)",
                          lambda: sel.quantiles(x, QS16), want,
                          "cp_histogram_multi")
    add(launches, "cp_histogram_multi", res)
    launches, res = drive(
        sel, cpo, "multi_order_statistic K=16 n=2^27 method=cp",
        lambda: sel.multi_order_statistic(x, ks, method="cp"), want,
        "cp_partials_multi")
    add(launches, "cp_partials_multi", res)
    del xs

    xb = x.to(torch.bfloat16)
    launches, res = drive(sel, cpo, "quantiles K=16 n=2^27 bf16 (binned)",
                          lambda: sel.quantiles(xb, QS16),
                          torch.sort(xb).values[ks.long() - 1],
                          "cp_histogram_multi")
    add(launches, "cp_histogram_multi", res)
    del xb

    xsmall = x[:N_SMALL].contiguous()
    ks_small = sel.ranks_from_quantiles(QS16, N_SMALL).to(DEVICE).long()
    launches, res = drive(sel, cpo, f"quantiles K=16 n={N_SMALL} auto (cp)",
                          lambda: sel.quantiles(xsmall, QS16),
                          torch.sort(xsmall).values[ks_small - 1],
                          "cp_partials_multi")
    add(launches, "cp_partials_multi", res)
    return total


# ---------------------------------------------------------------------------
# the weighted legs K1w-K4w and the weighted paths
# ---------------------------------------------------------------------------

# (x dtype, w dtype) pairs the weighted kernels take
WDTYPES = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
           (torch.float32, torch.bfloat16), (torch.bfloat16, torch.bfloat16))
# integer weights are exact in every f32 partial while the total stays
# below 2^24
EXACT_TOTAL = 1 << 24


def f32_chain(cpo, n: int) -> int:
    """The longest chain of f32 additions any weight goes through in a
    weighted kernel at length n: its thread's serial sum (one element per
    thread and grid stride), a slot group of at most 32 lanes, a warp
    shuffle (5), the warps of a block (8), and the fixed-order sum over the
    fg_blocks(n) block partials.  K1w's lane-private design stays within
    it: a thread's serial sum (256 threads a block), 32 columns, 8 warps
    (its end slots: 5 shuffle levels, 8 warps), then ``sum_blocks``, whose
    chain over nblk partials is ceil(nblk / 32) + 5 <= nblk + 5.  For
    non-negative terms a sum through such a chain is within chain * 2^-24
    of the exact sum, relative."""
    nblk = cpo.fg_blocks(n)
    per_thread = -(-n // (nblk * 256))
    return per_thread + 32 + 5 + 8 + nblk


def sorted_chain(cpo, n: int) -> int:
    """The longest chain of f32 additions a value goes through in K3s's
    and K3ws's sorted-tile design (``hist_multi_sums.cu``) at length n: its
    strip (``SORTED_ITEMS`` sorted positions), the strips of a slot (at
    most ``SORTED_TILE / SORTED_ITEMS``; the sums of the strips before or
    after a strip are shorter chains: a warp scan and the warps), the
    chunks of its block, and ``sum_blocks`` over the fg_blocks(n) partials
    (at most nblk, as in ``f32_chain``)."""
    nblk = cpo.fg_blocks(n)
    chunks = -(-n // cpo.SORTED_TILE)
    return (cpo.SORTED_ITEMS + cpo.SORTED_TILE // cpo.SORTED_ITEMS
            + -(-chunks // nblk) + nblk)


def sums_chain(cpo, n: int, nedges: int, nrows: int) -> int:
    """The chain of the design that serves a K3s (``nrows`` 1) or K3ws (2)
    call on ladders of ``nedges`` edges."""
    if cpo.hist_multi_sums_layout(nedges, nrows) == "sorted":
        return sorted_chain(cpo, n)
    return f32_chain(cpo, n)


def int_weights(shape, seed: int) -> torch.Tensor:
    """Integers 0..7, sparse enough that a row's total stays below 2^23,
    and zero over x in (0.5, 0.75] of ``special_data`` (the caller zeroes
    them), so that whole slots of a data-scale ladder carry no mass."""
    g = gen(seed)
    n = shape[-1]
    keep = min(1.0, (1 << 23) / (3.5 * n))
    w = torch.randint(0, 8, shape, generator=g, device=DEVICE).float()
    return w * (torch.rand(shape, generator=g, device=DEVICE) < keep)


def dense_weights(shape, seed: int) -> torch.Tensor:
    """Dense random f32 weights in [0.5, 1.5), as in an IRLS step."""
    return torch.rand(shape, generator=gen(seed), device=DEVICE) + 0.5


def weighted_inputs(rows, n, seed):
    """Data with the SPECIALS and two weight sets: integer weights (zero on
    (0.5, 0.75], so whole slots carry no mass) and dense random weights."""
    x = special_data(rows, n, seed)
    wi = int_weights((rows, n), seed + 1)
    wi[(x > 0.5) & (x <= 0.75)] = 0.0
    assert float(wi.sum(dim=1).max()) < EXACT_TOTAL
    return x, wi, dense_weights((rows, n), seed + 2)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


class WeightedCheck:
    """Tallies of one weighted kernel's checks: the largest count or mass
    difference with integer weights (it raises unless that is 0), the
    largest relative mass error with dense weights against the f64 plain
    version and its allowed bound, and the largest relative objective-sum
    error against the f32 plain version."""

    def __init__(self, name):
        self.name = name
        self.int_err = 0.0
        self.dense_rel = 0.0
        self.dense_bound = 0.0
        self.sum_rel = 0.0

    def exact(self, got, want, label):
        for g, v in zip(got, want):
            self.int_err = max(self.int_err,
                               float((g.double() - v.double()).abs().max()))
            if not torch.equal(g, v):
                raise AssertionError(f"{self.name} differs from its plain "
                                     f"version with integer weights: "
                                     f"{label}")

    def dense(self, got, exact, rtol, label):
        """``exact``: the f64 plain version (non-negative terms)."""
        err = (got.double() - exact).abs()
        scale = exact.abs()
        bad = err > rtol * scale
        if bool(bad.any()):
            raise AssertionError(f"{self.name} masses outside rtol {rtol:.3g} "
                                 f"of the f64 sums: {label}")
        nz = scale > 0
        if bool(nz.any()):
            self.dense_rel = max(self.dense_rel,
                                 float((err[nz] / scale[nz]).max()))
        self.dense_bound = max(self.dense_bound, rtol)

    def sums(self, got, want):
        for g, v in zip(got, want):
            torch.testing.assert_close(g, v, rtol=SUM_RTOL, atol=0,
                                       equal_nan=True)
            fin = torch.isfinite(v) & (v != 0)
            if bool(fin.any()):
                self.sum_rel = max(self.sum_rel, float(
                    ((g - v).abs()[fin] / v.abs()[fin]).max()))

    def repeat(self, call, label):
        a, b = call(), call()
        if not all(same_bits(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{self.name}: two launches on the same "
                                 f"input differ: {label}")

    def result(self):
        return {"max_abs_err": self.int_err,
                "dense_max_rel_err": self.dense_rel,
                "dense_rtol": self.dense_bound,
                "max_rel_err_objective_sums": self.sum_rel}


N_IDENT = (1 << 23) + 3  # fg_blocks(N_IDENT) == FG_MAX_BLOCKS (1024)


def check_k1w(cpo, ref) -> dict:
    chk = WeightedCheck("K1w")
    for rows, n, seed in K1_SHAPES:
        x32, wi32, wd32 = weighted_inputs(rows, n, seed + 40)
        ladders = k1_ladders(ref, x32, n)
        for xdt, wdt in WDTYPES:
            x, wi = x32.to(xdt), wi32.to(wdt)
            for label, e in ladders:
                want = ref.wcp_histogram_batched_ref(x, wi, e,
                                                     want_sums=False)[:2]
                for full in k1_designs(cpo, e.shape[1], 1, n):
                    got = cpo.wcp_histogram_batched(
                        x, wi, e, **full_kw(cpo, full))[:2]
                    chk.exact(got, want, f"({rows}, {n}) {xdt} {wdt} "
                                         f"{label} full={full}")
        x, wd = x32, wd32  # dense f32 weights: f64 sums, two launches
        rtol = f32_chain(cpo, n) * 2.0 ** -24
        for label, e in ladders:
            exact = ref.wcp_histogram_batched_ref(x, wd.double(), e,
                                                  want_sums=False)[1]
            for full in k1_designs(cpo, e.shape[1], 1, n):
                kw = full_kw(cpo, full)
                got = cpo.wcp_histogram_batched(x, wd, e, **kw)[1]
                chk.dense(got, exact, rtol, f"({rows}, {n}) {label} "
                                            f"full={full}")
                chk.repeat(lambda: cpo.wcp_histogram_batched(
                    x, wd, e, **kw)[:2], f"({rows}, {n}) {label}")
        del x32, wi32, wd32, x, wi, wd
    rows_alone_equal_batch(cpo, ref)
    log(f"K1w hist_batched weighted == plain version: counts and masses bit "
        f"for bit with integer weights (zero-mass slots included), dense "
        f"weights within {chk.dense_bound:.3g} of f64 (worst "
        f"{chk.dense_rel:.3g}), two launches identical, (rows, n) "
        f"{[s[:2] for s in K1_SHAPES]} with the first sweep's ladder and "
        f"8192 bins at n={N_ODD}, x and w each f32 and bf16, in each design "
        f"the call can take (lane-private with full_bracket at n >= "
        f"{cpo.LANE_ROWS_MIN_N}, grouped); at n={N_IDENT} with dense "
        f"weights each of 16 rows alone == its entry in the batch, bit for "
        f"bit, in both designs")
    return chk.result()


def rows_alone_equal_batch(cpo, ref, sel=None, obj=None,
                           check: bool = True):
    """K1w at n = N_IDENT (1024 block partials) with dense weights, 16
    rows on their first sweep's ladders: whether each row alone gives the
    same counts and masses, bit for bit, as its entry in the batch; with
    ``sel`` and ``obj``, by label, K1w and also K1s and K1ws on their
    polished first-sweep ladders, each row alone and the 16 permuted
    against the batch, in every design the call can take (raises if not,
    with ``check``)."""
    x = torch.randn((16, N_IDENT), generator=gen(301), device=DEVICE)
    wd = dense_weights((16, N_IDENT), 302)
    e = first_sweep_edges(ref, x, 128)
    out = {}
    same = True
    for full in k1_designs(cpo, e.shape[1], 1, N_IDENT):
        kw = full_kw(cpo, full)
        cnt, mass, _ = cpo.wcp_histogram_batched(x, wd, e, **kw)
        for r in range(16):
            c1, m1, _ = cpo.wcp_histogram_batched(x[r:r + 1], wd[r:r + 1],
                                                  e[r:r + 1], **kw)
            same &= torch.equal(cnt[r:r + 1], c1) and same_bits(
                mass[r:r + 1], m1)
    out["k1w first sweep"] = same
    if sel is not None:
        perm = torch.randperm(16, generator=gen(309), device=DEVICE)
        k = torch.full((16,), (N_IDENT + 1) // 2, device=DEVICE)
        for leg, w, nrows in (("k1s", None, 1), ("k1ws", wd, 2)):
            e = rows_polish_edges(sel, obj, x, k if w is None
                                  else 0.5 * w.sum(dim=1), w)
            same = True
            for full in k1_designs(cpo, e.shape[1], nrows, N_IDENT, True):
                got = rows_sums_call(cpo, x, w, e, full)
                for r in range(16):
                    one = rows_sums_call(cpo, x[r:r + 1],
                                    None if w is None else w[r:r + 1],
                                    e[r:r + 1], full)
                    same &= same_outputs([g[r:r + 1] for g in got], one)
                pw = None if w is None else w[perm].contiguous()
                same &= same_outputs([g[perm] for g in got], rows_sums_call(
                    cpo, x[perm].contiguous(), pw, e[perm].contiguous(),
                    full))
            out[f"{leg} polished first sweep"] = same
    if check and not all(out.values()):
        raise AssertionError(f"a row alone or the rows permuted differ from "
                             f"the batch of 16 (1024 blocks, dense "
                             f"weights): {out}")
    return out if sel is not None else out["k1w first sweep"]


def polish_first_edges(sel, obj, x, k, w=None) -> torch.Tensor:
    """The polished first sweep's ladders, as the engine builds them: the
    seed state and the analytic seed cut of a shared-x solve on ``x`` for
    targets ``k`` (ranks, or target masses with weights ``w``), one
    ``polish_edges`` ladder per target over [min, max], half its edges
    around its own cut (16 distinct ladders for 16 targets)."""
    ev = obj.SharedEvaluator(x, k, **({} if w is None else {"weights": w}))
    return polish_seed_edges(sel, ev)


def polish_seed_edges(sel, ev) -> torch.Tensor:
    """``binned_loop_batched``'s sweep-1 ladders with ``polish=True`` on
    the evaluator ``ev``: the seed state, the analytic seed cut (the
    bracket's middle where it is not strictly inside), ``polish_edges``
    over each target's [min, max] with 128 bins."""
    s0, xmin, xmax, kk, _, xmean = sel._seed_state(ev)
    cut0 = sel._seed_cut(ev, kk, xmin, xmax, xmean)
    bad = ~torch.isfinite(cut0) | (cut0 <= s0.yL) | (cut0 >= s0.yR)
    tp = torch.where(bad, 0.5 * (s0.yL + s0.yR), cut0)
    return sel.polish_edges(s0.yL, s0.yR, tp, 128).contiguous()


def rows_polish_edges(sel, obj, x, k, w=None) -> torch.Tensor:
    """The polished first sweep's ladders of a rows solve on ``x`` (B, n)
    for per-row targets ``k`` (ranks, or target masses with weights
    ``w``), as the engine builds them: one ``polish_edges`` ladder per row
    over its [min, max], half its edges around its own seed cut (the rows
    twin of ``polish_first_edges``)."""
    ev = obj.RowsEvaluator(x, k, **({} if w is None else {"weights": w}))
    return polish_seed_edges(sel, ev)


def rows_prior_edges(sel, obj, x, k, prior) -> torch.Tensor:
    """A warm tick's first-sweep ladders on ``x`` (B, n) for ranks ``k``:
    ``prior_edges`` over each row's [min, max] from ``prior`` (a
    ``SelectResult`` of the same rows), as ``binned_loop_batched`` builds
    them with ``prior=``."""
    ev = obj.RowsEvaluator(x, k)
    s0 = sel._seed_state(ev)[0]
    pb = sel._prior_to(sel.as_prior(prior), s0.yL.dtype, s0.yL)
    return sel.prior_edges(s0.yL, s0.yR, pb, 128).contiguous()


def identity_ladders(cpo, ref, sel, obj, x) -> dict:
    """The ladder sets of the company identities, on ``x`` (n,): a
    16-quantile descent's first sweep (16 identical ladders over [min,
    max]), the distinct narrow ladders its descent step picks, the five
    bracket kinds cycled over 16 (nested and disjoint brackets), 16
    staggered brackets each overlapping its neighbours in part, and the
    polished first sweep (``polish_first_edges``: 16 distinct full-range
    ladders, every element inside all of them)."""
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e1 = e1.contiguous()
    ks = sel.ranks_from_quantiles(QS16, x.numel()).to(DEVICE)
    cnt1 = cpo.cp_histogram_multi(x, e1)[0]
    cum = torch.cumsum(cnt1[:, :-1], dim=-1, dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e1, e1[:, 0], e1[:, -1], ks)
    kinds = bracket_kinds()
    return {"first sweep": e1,
            "narrow": ref.bin_edges(yl, yr, 128).contiguous(),
            "5 kinds cycled": edge_ladders(ref, [kinds[j % 5]
                                                 for j in range(16)], 128),
            "staggered": edge_ladders(ref, [(-2.0 + 0.25 * j, -1.0 + 0.25 * j)
                                            for j in range(16)], 128),
            "polished first sweep": polish_first_edges(sel, obj, x, ks)}


def same_outputs(a, b) -> bool:
    """Two histogram results equal, counts and f32 rows bit for bit."""
    return all(torch.equal(u, v) if u.dtype == torch.int32 else
               same_bits(u, v) for u, v in zip(a, b))


def sums_ladders_alone_equal_among_16(cpo, ref, sel, obj,
                                      check: bool = True) -> dict:
    """K3s and K3ws at n = N_IDENT (1024 block partials), K3ws with dense
    weights: per ladder set of ``identity_ladders``, whether each of 16
    ladders alone (the K = 1 views) gives the same counts, sums and masses,
    bit for bit, as its entry among the 16, and the 16 permuted the same as
    the 16 reordered (raises if not, with ``check``)."""
    x = torch.randn(N_IDENT, generator=gen(306), device=DEVICE)
    wd = dense_weights(N_IDENT, 307)
    perm = torch.randperm(16, generator=gen(308), device=DEVICE)
    legs = (("k3s", lambda e: cpo.cp_histogram_multi(x, e, want_sums=True),
             lambda e: cpo.cp_histogram(x, e, want_sums=True)),
            ("k3ws", lambda e: cpo.wcp_histogram_multi(x, wd, e,
                                                       want_sums=True),
             lambda e: cpo.wcp_histogram(x, wd, e, want_sums=True)))
    out = {}
    for label, e in identity_ladders(cpo, ref, sel, obj, x).items():
        for leg, multi, one in legs:
            got = multi(e)
            same = all(same_outputs([g[j] for g in got], one(e[j]))
                       for j in range(16))
            same &= same_outputs([g[perm] for g in got],
                                 multi(e[perm].contiguous()))
            out[f"{leg} {label}"] = same
            if check and not same:
                raise AssertionError(f"{leg}: a ladder alone or permuted "
                                     f"differs from its entry among 16 "
                                     f"({label}; 1024 blocks, dense "
                                     f"weights)")
    return out


def ladders_alone_equal_among_16(cpo, ref, sel, obj,
                                 check: bool = True) -> dict:
    """K3w at n = N_IDENT (1024 block partials) with dense weights: whether
    each of 16 ladders alone gives the same counts and masses, bit for bit,
    as its entry among the 16, and a permutation of the 16 the same as the
    16 permuted, on every ladder set of ``identity_ladders``: identical,
    disjoint, nested, partly overlapping and fully overlapping ladders
    (raises if not, with ``check``); with ``full_bracket`` (a first sweep
    of identical ladders bins the one ladder) the same bits again."""
    x = torch.randn(N_IDENT, generator=gen(303), device=DEVICE)
    wd = dense_weights(N_IDENT, 304)
    cases = identity_ladders(cpo, ref, sel, obj, x)
    perm = torch.randperm(16, generator=gen(305), device=DEVICE)
    out = {}
    kw = k3_kw(cpo, True, cpo.wcp_histogram_multi)
    for label, e in cases.items():
        cnt, mass, _ = cpo.wcp_histogram_multi(x, wd, e)
        # with full_bracket a first sweep of identical ladders bins one
        cf, mf, _ = cpo.wcp_histogram_multi(x, wd, e, **kw)
        same = torch.equal(cnt, cf) and same_bits(mass, mf)
        for j in range(16):
            c1, m1, _ = cpo.wcp_histogram(x, wd, e[j])
            same &= torch.equal(cnt[j], c1) and same_bits(mass[j], m1)
        cp, mp, _ = cpo.wcp_histogram_multi(x, wd, e[perm].contiguous())
        same &= torch.equal(cnt[perm], cp) and same_bits(mass[perm], mp)
        out[label] = same
        if check and not same:
            raise AssertionError(f"K3w: a ladder alone or permuted differs "
                                 f"from its entry among 16 ({label}; 1024 "
                                 f"blocks, dense weights)")
    return out


def check_k2w(cpo, ref) -> dict:
    chk = WeightedCheck("K2w")
    pivots = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5], device=DEVICE)
    for rows, n, seed in K2_SHAPES:
        x32, wi32, wd32 = weighted_inputs(rows, n, seed + 50)
        y = pivots[torch.arange(rows, device=DEVICE) % pivots.numel()]
        y[-1] = x32[-1, 12345]  # a pivot on a data value
        for xdt, wdt in WDTYPES:
            x, wi = x32.to(xdt), wi32.to(wdt)
            got = cpo.wcp_partials_batched(x, wi, y)
            want = ref.wcp_partials_batched_ref(x, wi, y)
            chk.exact(got[2:], want[2:], f"({rows}, {n}) {xdt} {wdt}")
            chk.sums(got[:2], want[:2])
        rtol = f32_chain(cpo, n) * 2.0 ** -24
        got = cpo.wcp_partials_batched(x32, wd32, y)
        exact = ref.wcp_partials_batched_ref(x32, wd32.double(), y)
        for g, v in zip(got[2:4], exact[2:4]):
            chk.dense(g, v, rtol, f"({rows}, {n})")
        chk.sums(got[:2], ref.wcp_partials_batched_ref(x32, wd32, y)[:2])
        chk.repeat(lambda: cpo.wcp_partials_batched(x32, wd32, y),
                   f"({rows}, {n})")
        del x32, wi32, wd32, x, wi
    log(f"K2w fg_batched weighted == plain version: counts and masses bit for "
        f"bit with integer weights, dense masses within "
        f"{chk.dense_bound:.3g} of f64 (worst {chk.dense_rel:.3g}), objective "
        f"sums within rtol {SUM_RTOL} (worst {chk.sum_rel:.3g}), two launches "
        f"identical, (rows, n) {[s[:2] for s in K2_SHAPES]}, x and w each "
        f"f32 and bf16")
    return chk.result()


def check_k3w(cpo, ref, sel, obj) -> dict:
    kinds = bracket_kinds()
    chk = WeightedCheck("K3w")
    cases = ((N_BIG, 61, [("16 identical", [kinds[1]] * 16, 128),
                          ("5 kinds cycled over 16",
                           [kinds[j % 5] for j in range(16)], 128)]),
             (N_ODD, 62, [("K=64", [kinds[j % 5] for j in range(64)], 128),
                          ("K=3 at 8192 bins", [kinds[j] for j in range(3)],
                           8192)]))
    for n, seed, ladders in cases:
        x32, wi32, wd32 = (t[0] for t in weighted_inputs(1, n, seed))
        for xdt, wdt in WDTYPES:
            x, wi = x32.to(xdt), wi32.to(wdt)
            for label, ladder, nbins in ladders:
                e = edge_ladders(ref, ladder, nbins)
                want = ref.wcp_histogram_multi_ref(x, wi, e,
                                                   want_sums=False)[:2]
                for full in (False, True):  # all ladders, or the one
                    got = cpo.wcp_histogram_multi(
                        x, wi, e, **k3_kw(cpo, full,
                                          cpo.wcp_histogram_multi))[:2]
                    chk.exact(got, want, f"n={n} {xdt} {wdt} {label} "
                                         f"full={full}")
            if n == N_ODD:
                for kind in kinds:  # K = 1 through the scalar view
                    e1 = edge_ladders(ref, [kind], 128)[0]
                    chk.exact(cpo.wcp_histogram(x, wi, e1)[:2],
                              ref.wcp_histogram_ref(x, wi, e1,
                                                    want_sums=False)[:2],
                              f"n={n} {xdt} {wdt} K=1 {kind}")
        rtol = f32_chain(cpo, n) * 2.0 ** -24
        for label, ladder, nbins in ladders:
            e = edge_ladders(ref, ladder, nbins)
            got = cpo.wcp_histogram_multi(x32, wd32, e)[1]
            exact = ref.wcp_histogram_multi_ref(x32, wd32.double(), e,
                                                want_sums=False)[1]
            chk.dense(got, exact, rtol, f"n={n} {label}")
            chk.repeat(lambda: cpo.wcp_histogram_multi(x32, wd32, e)[:2],
                       f"n={n} {label}")
        del x32, wi32, wd32, x, wi
    ident = ladders_alone_equal_among_16(cpo, ref, sel, obj)
    log(f"K3w hist_multi weighted == plain version: counts and masses bit for "
        f"bit with integer weights at n=2^27 K=16 (identical and cycled "
        f"ladders), n={N_ODD} K=64, K=3 at 8192 bins and K=1 "
        f"(wcp_histogram), dense masses within {chk.dense_bound:.3g} of f64 "
        f"(worst {chk.dense_rel:.3g}), two launches identical, x and w each "
        f"f32 and bf16; at n={N_IDENT} with dense weights a ladder alone and "
        f"the 16 permuted == its entry among 16: {json.dumps(ident)}")
    return {**chk.result(), "alone_equals_among_16": ident}


def check_k4w(cpo, ref) -> dict:
    chk = WeightedCheck("K4w")
    pivots = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5, -2.0, 0.7],
                          device=DEVICE)
    for n, k, seed in ((N_BIG, 16, 71), (N_SMALL, 16, 72), (N_ODD, 64, 73),
                       (N_ODD, 17, 74)):
        x32, wi32, wd32 = (t[0] for t in weighted_inputs(1, n, seed))
        y = pivots[torch.arange(k, device=DEVICE) % pivots.numel()]
        y[-1] = x32[12345]  # a pivot on a data value
        if k == 17:  # the first group of 16 holds non-finite pivots
            y[:3] = torch.tensor(NONFINITE, device=DEVICE)
        for xdt, wdt in WDTYPES:
            x, wi = x32.to(xdt), wi32.to(wdt)
            label = f"n={n} K={k} {xdt} {wdt}"
            got = cpo.wcp_partials_multi(x, wi, y)
            want = ref.wcp_partials_multi_ref(x, wi, y)
            chk.exact(got[2:], want[2:], label)
            chk.sums(got[:2], want[:2])
            one = cpo.wcp_partials(x, wi, y[-1])
            chk.exact([g[None] for g in one[2:]],
                      [v[-1:] for v in want[2:]], label + " K=1")
            pivot_identities(
                "K4w", lambda yy: cpo.wcp_partials_multi(x, wi, yy),
                lambda yy: cpo.wcp_partials(x, wi, yy[0]),
                lambda yy: cpo.wcp_partials_batched(x[None], wi[None], yy),
                y, label)
        rtol = f32_chain(cpo, n) * 2.0 ** -24
        got = cpo.wcp_partials_multi(x32, wd32, y)
        exact = ref.wcp_partials_multi_ref(x32, wd32.double(), y)
        for g, v in zip(got[2:4], exact[2:4]):
            chk.dense(g, v, rtol, f"n={n} K={k}")
        chk.sums(got[:2], ref.wcp_partials_multi_ref(x32, wd32, y)[:2])
        pivot_identities(
            "K4w", lambda yy: cpo.wcp_partials_multi(x32, wd32, yy),
            lambda yy: cpo.wcp_partials(x32, wd32, yy[0]),
            lambda yy: cpo.wcp_partials_batched(x32[None], wd32[None], yy),
            y, f"n={n} K={k} dense weights")
        del x32, wi32, wd32, x, wi
    log(f"K4w fg_multi weighted == plain version: counts and masses bit for "
        f"bit with integer weights, dense masses within "
        f"{chk.dense_bound:.3g} of f64 (worst {chk.dense_rel:.3g}), objective "
        f"sums within rtol {SUM_RTOL} (worst {chk.sum_rel:.3g}), (n, K) "
        f"(2^27, 16), ({N_SMALL}, 16), ({N_ODD}, 64), ({N_ODD}, 17) with "
        f"inf/-inf/NaN pivots, and K=1 (wcp_partials), x and w each f32 and "
        f"bf16; two launches, permuted pivots and each pivot alone (K=1 and "
        f"K2w) bit for bit, integer and dense weights")
    return chk.result()


def sorted_mass(x: torch.Tensor, w: torch.Tensor):
    """The library way to weighted order statistics: ``torch.sort``, a
    gather of the weights and an f64 ``torch.cumsum`` (the oracle of the
    weighted paths; the port never calls it)."""
    xs, order = torch.sort(x)
    return xs, torch.cumsum(torch.gather(w, -1, order).double(), dim=-1)


def mass_oracle(xs, cum, wk):
    """Smallest sorted value whose cumulative mass reaches each ``wk``
    (``torch.searchsorted`` on the f64 prefix masses)."""
    wk = torch.as_tensor(wk, device=DEVICE).double().reshape(-1)
    idx = torch.searchsorted(cum, wk.reshape(cum.shape[:-1] + (-1,))
                             ).clamp(max=cum.shape[-1] - 1)
    return torch.gather(xs, -1, idx).reshape(-1)


def has_block_sums(key: str) -> bool:
    """Whether the wrapper counted under ``LAUNCHES[key]`` sums f32 block
    partials with ``sum_blocks`` (one launch per pass): the partials
    kernels, and the histogram legs with rows (weighted or sums legs)."""
    return ("partials" in key or key.startswith("w")
            or key.endswith("_sums"))


def block_sum_passes(launches: dict) -> int:
    """The passes in ``launches`` that sum their block partials."""
    return sum(v for k, v in launches.items()
               if k != "sum_blocks" and has_block_sums(k))


def drive_only(sel, cpo, label, fn, check, expect_kernel):
    """Run one call with the launch counts read from zero; ``check(res)``
    raises unless the values are right.  Only ``expect_kernel`` may launch,
    once per sweep or pass, besides the row sums of the rows path and the
    finalize (``row_sums``)."""
    cpo.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cpo.LAUNCHES)
    check(res)
    if bool((res.status == sel.NOT_CONVERGED).any()):
        raise AssertionError(f"{label}: NOT_CONVERGED")
    moved = {k for k, v in launches.items() if v}
    # a pass with f32 block partials sums them with sum_blocks, and so
    # does each row sum
    block_sums = (launches[expect_kernel] if has_block_sums(expect_kernel)
                  else 0) + launches.get("row_sums", 0)
    if (moved - {"sum_blocks", "row_sums"} != {expect_kernel}
            or launches["sum_blocks"] != block_sums):
        raise AssertionError(f"{label}: launched {launches}, expected only "
                             f"{expect_kernel} (and sum_blocks as often on "
                             f"a leg with f32 partials)")
    if launches[expect_kernel] != int(res.iters.max()):
        raise AssertionError(f"{label}: {launches[expect_kernel]} launches "
                             f"for {int(res.iters.max())} sweeps or passes")
    log(f"{label}: iters {sorted(set(res.iters.reshape(-1).tolist()))[:8]} "
        f"status {sorted(set(res.status.reshape(-1).tolist()))} launches "
        f"{ {k: launches[k] for k in moved} } first call "
        f"{wall * 1e3:.1f} ms")
    return launches


def mass_interval(cpo, x, wd):
    """A check of a dense-weight median: the answer's f64 masses below and
    at or below it bracket wk = W/2 within ``delta``.  Returns the check
    and the dict it fills with the margins."""
    xs, cum = sorted_mass(x, wd)
    W = float(cum[-1])
    wk = W / 2
    # delta: the kernel's chain (f32_chain) bounds the error of each slot
    # mass and prefix, and the engine's torch.sum reductions (W, the
    # finalize's mass below the bracket and at vnext) are each taken as no
    # longer: four such chains, relative 2^-24 each, of the total W
    delta = 4 * f32_chain(cpo, x.numel()) * 2.0 ** -24 * W
    margins = {}

    def in_interval(res):
        v = torch.tensor([float(res.value)], device=DEVICE)
        m_lt = float(cum[int(torch.searchsorted(xs, v, side="left")) - 1]) \
            if bool(xs[0] < v) else 0.0
        m_le = float(cum[int(torch.searchsorted(xs, v, side="right")) - 1])
        margins.update(m_lt_minus_wk=m_lt - wk, m_le_minus_wk=m_le - wk,
                       delta=delta)
        if not (m_lt < wk + delta and m_le >= wk - delta):
            raise AssertionError(f"dense weighted median outside the mass "
                                 f"interval: M(<v)-wk {m_lt - wk}, "
                                 f"M(<=v)-wk {m_le - wk}, delta {delta}")

    return in_interval, margins


def weighted_path(sel, cpo) -> dict:
    """The weighted entry points at full size; each value checked against
    the sort + f64 cumulative-mass oracle."""
    total = dict.fromkeys(cpo.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    def equal_to(want):
        def check(res):
            if not torch.equal(res.value.float().reshape(-1),
                               want.float().reshape(-1)):
                raise AssertionError("value differs from the sort + f64 "
                                     "cumulative-mass oracle")
        return check

    x = torch.randn(N_BIG, generator=gen(81), device=DEVICE)
    # 0/1 weights at density 1/16: total ~8.4e6 < 2^24, every mass exact
    w01 = (torch.rand(N_BIG, generator=gen(82), device=DEVICE)
           < 1 / 16).float()
    W01 = float(w01.sum())
    assert W01 < EXACT_TOTAL
    xs, cum = sorted_mass(x, w01)
    add(drive_only(sel, cpo, "weighted_median n=2^27 f32, 0/1 weights "
                   "(binned)", lambda: sel.weighted_median(x, w01),
                   equal_to(mass_oracle(xs, cum, 0.5 * W01)),
                   "wcp_histogram_batched"))
    wk_cp = float(torch.tensor(W01 / 3, dtype=torch.float32))
    add(drive_only(sel, cpo, "weighted_order_statistic n=2^27 "
                   "method=cp, 0/1 weights",
                   lambda: sel.weighted_order_statistic(
                       x, w01, wk_cp, method="cp"),
                   equal_to(mass_oracle(xs, cum, wk_cp)),
                   "wcp_partials_batched"))
    # 16 weighted quantiles: target masses q * W rounded once to f32
    wks16 = torch.tensor(QS16 * W01, dtype=torch.float32)
    want16 = mass_oracle(xs, cum, wks16)
    add(drive_only(sel, cpo, "weighted_quantiles K=16 n=2^27, 0/1 "
                   "weights (binned)",
                   lambda: sel.weighted_quantiles(x, w01, QS16),
                   equal_to(want16), "wcp_histogram_multi"))
    add(drive_only(sel, cpo, "weighted_multi_order_statistic K=16 "
                   "n=2^27 method=cp",
                   lambda: sel.weighted_multi_order_statistic(
                       x, w01, wks16.to(DEVICE), method="cp"),
                   equal_to(want16), "wcp_partials_multi"))
    del xs, cum

    xsmall, wsmall = x[:N_SMALL].contiguous(), w01[:N_SMALL].contiguous()
    wsmall[0] = 1.0
    xs, cum = sorted_mass(xsmall, wsmall)
    wk_s = 0.5 * float(wsmall.sum())
    add(drive_only(sel, cpo, f"weighted_median n={N_SMALL} auto (cp)",
                   lambda: sel.weighted_median(xsmall, wsmall),
                   equal_to(mass_oracle(xs, cum, wk_s)),
                   "wcp_partials_batched"))

    xb = x.to(torch.bfloat16)
    xs, cum = sorted_mass(xb, w01)
    add(drive_only(sel, cpo, "weighted_median n=2^27 bf16 x, 0/1 "
                   "weights (binned)", lambda: sel.weighted_median(xb, w01),
                   equal_to(mass_oracle(xs, cum, 0.5 * W01)),
                   "wcp_histogram_batched"))
    del xb, xs, cum

    # dense weights, as in an IRLS step: no f32 sum of 2^27 masses is
    # exact, so the check is a mass interval around wk = W/2 (in f64)
    wd = dense_weights(N_BIG, 83)
    in_interval, margins = mass_interval(cpo, x, wd)

    add(drive_only(sel, cpo, "weighted_median n=2^27 f32, dense weights "
                   "(binned)", lambda: sel.weighted_median(x, wd),
                   in_interval, "wcp_histogram_batched"))
    log(f"  dense-weight median mass interval: {json.dumps(margins)}")
    del wd, x, w01, in_interval

    xr = torch.randn((ROWS, N_ROW), generator=gen(84), device=DEVICE)
    wr = torch.randint(0, 8, (ROWS, N_ROW), generator=gen(85),
                       device=DEVICE).float()
    Wr = wr.sum(dim=1)
    assert float(Wr.max()) < EXACT_TOTAL
    wks = (torch.rand(ROWS, generator=gen(86), device=DEVICE) * Wr).floor()
    xs, cum = sorted_mass(xr, wr)
    add(drive_only(sel, cpo, "weighted_select_rows (64, 2^20), integer "
                   "weights, per-row target masses",
                   lambda: sel.weighted_select_rows(xr, wr, wks),
                   equal_to(mass_oracle(xs, cum, wks[:, None])),
                   "wcp_histogram_batched"))
    return total, margins


def weighted_timings(sel, cpo, ref, obj) -> dict:
    """K1w-K4w at the main path's shapes, their plain versions and bounds,
    and the weighted paths end to end against the sort + cumsum
    yardstick."""
    out = {}
    x = torch.randn(N_BIG, generator=gen(91), device=DEVICE)
    wd = dense_weights(N_BIG, 92)
    w01 = (torch.rand(N_BIG, generator=gen(93), device=DEVICE)
           < 1 / 16).float()
    x2, w2 = x[None, :], wd[None, :]
    nblk = cpo.fg_blocks(N_BIG)
    io = N_BIG * 8  # x and w, f32
    # K1w at the first sweep's full-data bracket (every element inside)
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].contiguous()
    fk = full_kw(cpo)
    cnt, _, _ = cpo.wcp_histogram_batched(x2, w2, e1, **fk)
    inside = int(N_BIG - cnt[0, 0] - cnt[0, -1])
    steps = math.ceil(math.log2(e1.shape[1]))
    e3 = ref.bin_edges(torch.tensor(-1e-3, device=DEVICE),
                       torch.tensor(2e-3, device=DEVICE), 128)[None, :]
    out["k1w"] = dict(
        ms=cuda_ms(lambda: cpo.wcp_histogram_batched(x2, w2, e1, **fk),
                   reps=20),
        plain_ms=cuda_ms(lambda: ref.wcp_histogram_batched_ref(
            x2, w2, e1, want_sums=False), reps=2, rounds=3),
        # compares and a mass add per element, a search and an add inside
        bound=bound(io + e1.numel() * 4 + 2 * cnt.numel() * 4,
                    3 * N_BIG + inside * (steps + 1)),
        narrow_ms=cuda_ms(lambda: cpo.wcp_histogram_batched(x2, w2, e3),
                          reps=20))
    y = torch.zeros(1, device=DEVICE)
    out["k2w"] = dict(
        ms=cuda_ms(lambda: cpo.wcp_partials_batched(x2, w2, y), reps=20),
        plain_ms=cuda_ms(lambda: ref.wcp_partials_batched_ref(x2, w2, y),
                         reps=2, rounds=3),
        # per element: 1 subtract, 3 compares, 2 multiplies, 4 selects,
        # 4 f32 adds and 2 count adds
        bound=bound(io + 4 + nblk * 24, 16 * N_BIG))
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    e16 = e1.expand(16, -1).contiguous()
    cnt16, _, _ = cpo.wcp_histogram_multi(x, wd, e16)
    cum = torch.cumsum(cnt16[:, :-1], dim=-1, dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e16, e16[:, 0], e16[:, -1], ks)
    e2 = ref.bin_edges(yl, yr, 128).contiguous()
    cnt2, _, _ = cpo.wcp_histogram_multi(x, wd, e2)
    for label, e, c in (("k3w_first", e16, cnt16), ("k3w_narrow", e2, cnt2)):
        nbytes, ops = k3_work(x, e, c)  # one read of x, compares, searches
        distinct = len({r.numpy().tobytes() for r in e.cpu()})
        kw = k3_kw(cpo, label == "k3w_first", cpo.wcp_histogram_multi)
        out[label] = dict(
            ms=cuda_ms(lambda: cpo.wcp_histogram_multi(x, wd, e, **kw),
                       reps=20),
            plain_ms=cuda_ms(lambda: ref.wcp_histogram_multi_ref(
                x, wd, e, want_sums=False), reps=1, rounds=3),
            # + the weights read once, the mass output, and two selected
            # mass adds per element and distinct ladder
            bound=bound(nbytes + N_BIG * 4 + c.numel() * 4,
                        ops + 2 * N_BIG * distinct),
            distinct_ladders=distinct)
    # K3w's kernel on all 16 of the first sweep's ladders (the main path
    # bins the one ladder there)
    out["k3w_first"]["all_ladders_ms"] = cuda_ms(
        lambda: cpo.wcp_histogram_multi(x, wd, e16), reps=20)
    xs = torch.sort(x).values
    y16 = xs[ks.long() - 1]
    out["k4w"] = dict(
        ms=cuda_ms(lambda: cpo.wcp_partials_multi(x, wd, y16), reps=20),
        plain_ms=cuda_ms(lambda: ref.wcp_partials_multi_ref(x, wd, y16),
                         reps=1, rounds=3),
        bound=bound(io + 16 * 4 + nblk * 16 * 24, K4W_OPS * 16 * N_BIG))
    out["k4w_sweep_ms"] = k_sweep(sel, cpo, xs, x, wd)
    del xs

    # end to end, against the library way: sort + gather + cumsum +
    # searchsorted
    def yardstick(xv, wv, wk):
        xs, order = torch.sort(xv, dim=-1)
        cumw = torch.cumsum(torch.gather(wv, -1, order), dim=-1)
        idx = torch.searchsorted(cumw, wk).clamp(max=xv.shape[-1] - 1)
        return torch.gather(xs, -1, idx)

    W = wd.sum()
    out["wmedian_dense_ms"] = cuda_ms(lambda: sel.weighted_median(x, wd),
                                      reps=1, rounds=5)
    out["wmedian_01_ms"] = cuda_ms(lambda: sel.weighted_median(x, w01),
                                   reps=1, rounds=5)
    out["wmedian_yardstick_ms"] = cuda_ms(
        lambda: yardstick(x, wd, (0.5 * W).reshape(1)), reps=1, rounds=5)
    xr = torch.randn((ROWS, N_ROW), generator=gen(94), device=DEVICE)
    wr = torch.randint(0, 8, (ROWS, N_ROW), generator=gen(95),
                       device=DEVICE).float()
    wks = (torch.rand(ROWS, generator=gen(96), device=DEVICE)
           * wr.sum(dim=1)).floor()
    out["wrows_ms"] = cuda_ms(lambda: sel.weighted_select_rows(xr, wr, wks),
                              reps=1, rounds=5)
    out["wrows_yardstick_ms"] = cuda_ms(
        lambda: yardstick(xr, wr, wks[:, None].contiguous()), reps=1,
        rounds=5)
    W01 = float(w01.sum())
    wks16 = torch.tensor(QS16 * W01, dtype=torch.float32, device=DEVICE)
    out["wquantiles_ms"] = cuda_ms(
        lambda: sel.weighted_quantiles(x, w01, QS16), reps=1, rounds=3)
    out["wquantiles_yardstick_ms"] = cuda_ms(
        lambda: yardstick(x, w01, wks16), reps=1, rounds=5)

    # where the time goes: the stats pass (with the total mass), the sweep
    # loop (which includes the stats pass) and the finalize (compaction of
    # (value, weight) pairs, argsort, mass probes)
    for label, make, cap, fin in (
            ("wmedian_dense",
             lambda: obj.RowsEvaluator(x2, 0.5 * W, weights=w2),
             sel._default_cap(N_BIG), sel._finalize_rows),
            ("wrows", lambda: obj.RowsEvaluator(xr, wks, weights=wr),
             sel._default_cap_rows(N_ROW), sel._finalize_rows),
            ("wquantiles",
             lambda: obj.SharedEvaluator(x, wks16, weights=w01),
             sel._default_cap_rows(N_BIG), sel._finalize_shared)):
        out[f"{label}_stats_ms"] = cuda_ms(lambda: make().init_stats(),
                                           reps=1, rounds=5)
        ev = make()
        out[f"{label}_loop_ms"] = cuda_ms(lambda: sel.binned_loop_batched(
            ev, nbins=128, cap=cap), reps=1, rounds=3)
        s, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cap)
        out[f"{label}_finalize_ms"] = cuda_ms(lambda: fin(
            ev.x, ev.k, s, cap, xmin, xmax, w=ev.w.to(ev.k.dtype)), reps=1,
            rounds=3)
        out[f"{label}_sweeps"] = int(s.iters.max())
    return out


# ---------------------------------------------------------------------------
# the per-slot sums legs K1s, K1ws, K3s, K3ws; the polished and warm paths
# ---------------------------------------------------------------------------

def int_sparse_data(rows: int, n: int, seed: int) -> torch.Tensor:
    """Integer-valued x: -4..4 at density 1/128, zeros elsewhere, with ±inf,
    NaN and ±0.0 planted.  A slot's sum of |x| stays below 2^22 at
    n = 2^27 (and of |w*x| with ``int_weights``, whose total stays below
    2^23), so every f32 partial sum is exact in any order and the kernels'
    sums must equal the plain versions' bit for bit."""
    g = gen(seed)
    v = torch.randint(-4, 5, (rows, n), generator=g, device=DEVICE).float()
    x = v * (torch.rand((rows, n), generator=g, device=DEVICE) < 1 / 128)
    sp = torch.tensor([float("inf"), float("-inf"), float("nan"), 0.0, -0.0],
                      device=DEVICE)
    pos = torch.randint(0, n, (rows, 6 * sp.numel()), generator=g,
                        device=DEVICE)
    x.scatter_(1, pos, sp.repeat(6).expand(rows, -1).contiguous())
    return x


class SumsCheck:
    """Tallies of one sums leg's checks: the largest count / mass / sum
    difference on integer data (it raises unless that is 0 outside NaN
    slots), and on randn the largest error of a slot sum against the f64
    plain version relative to the slot's sum of |values|, with its
    bound."""

    def __init__(self, name):
        self.name = name
        self.int_err = 0.0
        self.rel = 0.0
        self.bound = 0.0

    def exact(self, got, want, label):
        if not torch.equal(got[0], want[0]):
            raise AssertionError(f"{self.name} counts differ from the plain "
                                 f"version: {label}")
        for g, v in zip(got[1:], want[1:]):
            fin = torch.isfinite(v)
            if bool(fin.any()):
                self.int_err = max(self.int_err, float(
                    (g[fin].double() - v[fin].double()).abs().max()))
            torch.testing.assert_close(g, v, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{self.name} rows differ from "
                                           f"the plain version: {label}")

    def near(self, got, exact, scale, cnt, chain, label):
        """``got`` against the f64 ``exact`` where both the sum and its
        scale are finite f32 values (a slot holding ±inf, NaN or ±3e38
        pairs has no f32 sum to hold).  Each of the slot's ``cnt`` f32
        products w*x may round by half a denormal step, 2^-150, beyond the
        relative chain bound."""
        rtol = chain * 2.0 ** -24
        ok = torch.isfinite(exact) & (scale < 1e38)
        err = (got.double() - exact).abs()[ok]
        sc = scale[ok]
        if bool((err > rtol * sc + cnt[ok].double() * 2.0 ** -150).any()):
            raise AssertionError(f"{self.name} sums outside {rtol:.3g} of "
                                 f"the f64 sums: {label}")
        nz = sc > 0
        if bool(nz.any()):
            self.rel = max(self.rel, float((err[nz] / sc[nz]).max()))
        self.bound = max(self.bound, rtol)

    def repeat(self, call, label):
        a, b = call(), call()
        if not all(same_bits(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"{self.name}: two launches on the same "
                                 f"input differ: {label}")

    def result(self):
        return {"max_abs_err": self.int_err, "randn_max_rel_err": self.rel,
                "randn_rtol": self.bound}


def f64_sums(plain, x, w, e):
    """The f64 plain version's per-slot sums of w*x and of w*|x| (the
    scale of their rounding), ``w`` None for the counting legs."""
    xd = x.double()
    wd = torch.ones_like(xd) if w is None else w.double()
    return (plain(xd, wd, e, want_sums=True)[2],
            plain(xd, wd * torch.sign(xd).nan_to_num(0.0), e,
                  want_sums=True)[2].abs())


def k1_sums_ladders(sel, obj, ref, x, n):
    """(label, edges) of the K1s and K1ws checks on ``x`` (B, n): the five
    bracket kinds (one per row for a batch, each in turn for B = 1), and
    the first sweeps the engine bins (made from ``x`` with its non-finite
    values set to 0): the polished one (``rows_polish_edges``), a warm
    tick's (``rows_prior_edges``, from a cold answer on the same rows) and
    at ``N_ODD`` the uniform one at 8192 bins (past the lane-column
    tables: the grouped design)."""
    kinds = bracket_kinds()
    rows = x.shape[0]
    ladders = ([[kinds[i % len(kinds)] for i in range(rows)]]
               if rows > 1 else [[kind] for kind in kinds])
    out = [(str(ladder[:3]), edge_ladders(ref, ladder, 128))
           for ladder in ladders]
    xc = torch.nan_to_num(x.float(), nan=0.0, posinf=0.0, neginf=0.0)
    k = torch.full((rows,), (n + 1) // 2, device=DEVICE)
    out.append(("polished first sweep", rows_polish_edges(sel, obj, xc, k)))
    out.append(("prior", rows_prior_edges(sel, obj, xc, k,
                                          sel.select_rows(xc, k))))
    if n == N_ODD:
        out.append(("first sweep, 8192 bins", first_sweep_edges(ref, x,
                                                                8192)))
    return out


def check_sums_rows(cpo, ref, sel, obj) -> tuple:
    """K1s and K1ws against their plain versions at the K1 shapes, on the
    ladders of ``sums_row_ladders``, in every design the call can take (the
    lane-column design with ``full_bracket`` on rows of at least
    ``LANE_SUMS_MIN_N``, the grouped one); each row alone against its
    entry in a batch (``rows_alone_equal_batch``)."""
    c1s, c1ws = SumsCheck("K1s"), SumsCheck("K1ws")
    legs = ((c1s, False, 1), (c1ws, True, 2))
    for rows, n, seed in K1_SHAPES:
        xi = int_sparse_data(rows, n, seed + 100)
        wi = int_weights((rows, n), seed + 101)
        ladders = k1_sums_ladders(sel, obj, ref, xi, n)
        for label, e in ladders:
            for chk, weighted, nrows in legs:
                pairs = (WDTYPES if weighted else
                         ((torch.float32, None), (torch.bfloat16, None)))
                for xdt, wdt in pairs:
                    x = xi.to(xdt)
                    w = None if wdt is None else wi.to(wdt)
                    want = (ref.cp_histogram_batched_ref(x, e, want_sums=True)
                            if w is None else ref.wcp_histogram_batched_ref(
                                x, w, e, want_sums=True))
                    for full in k1_designs(cpo, e.shape[1], nrows, n, True):
                        chk.exact(rows_sums_call(cpo, x, w, e, full), want,
                                  f"({rows}, {n}) {xdt} {wdt} {label} "
                                  f"full={full}")
        del xi, wi
        x = special_data(rows, n, seed + 102)
        wd = dense_weights((rows, n), seed + 103)
        chain = f32_chain(cpo, n)
        plain = ref.wcp_histogram_batched_ref
        for label, e in k1_sums_ladders(sel, obj, ref, x, n):
            for chk, weighted, nrows in legs:
                w = wd if weighted else None
                for full in k1_designs(cpo, e.shape[1], nrows, n, True):
                    got = rows_sums_call(cpo, x, w, e, full)
                    chk.near(got[-1], *f64_sums(plain, x, w, e), got[0],
                             chain, f"({rows}, {n}) {label} full={full}")
                    chk.repeat(lambda: rows_sums_call(cpo, x, w, e, full),
                               f"({rows}, {n}) {label} full={full}")
        del x, wd
    ident = rows_alone_equal_batch(cpo, ref, sel, obj)
    log(f"K1s/K1ws hist_batched sums legs == plain version: counts, masses "
        f"and sums bit for bit on integer data with inf/NaN/±0 (x and w "
        f"each f32 and bf16), randn sums within {c1s.bound:.3g} of f64 "
        f"(worst {c1s.rel:.3g} / {c1ws.rel:.3g} of the slot's |sum|), two "
        f"launches identical, (rows, n) {[s[:2] for s in K1_SHAPES]}, on "
        f"the bracket kinds and the polished, prior and (n={N_ODD}) "
        f"8192-bin first sweeps, in each design the call can take; at "
        f"n={N_IDENT} a row alone and the rows permuted == the batch of "
        f"16: {json.dumps(ident)}")
    return ({**c1s.result(), "alone_equals_batch": {
                k.split(" ", 1)[1]: v for k, v in ident.items()
                if k.startswith("k1s ")}},
            {**c1ws.result(), "alone_equals_batch": {
                k.split(" ", 1)[1]: v for k, v in ident.items()
                if k.startswith("k1ws ")}})


def check_sums_multi(cpo, ref, sel, obj) -> tuple:
    """K3s and K3ws against their plain versions at the K3 shapes, and
    their company identities (``sums_ladders_alone_equal_among_16``)."""
    kinds = bracket_kinds()
    c3s, c3ws = SumsCheck("K3s"), SumsCheck("K3ws")
    cases = ((N_BIG, 121, [("16 identical", [kinds[1]] * 16, 128),
                           ("5 kinds cycled over 16",
                            [kinds[j % 5] for j in range(16)], 128)]),
             (N_ODD, 122, [("K=64", [kinds[j % 5] for j in range(64)], 128),
                           ("K=3 at 8192 bins", [kinds[j] for j in range(3)],
                            8192),
                           # past the sorted tile's shared memory: the
                           # grouped design
                           ("K=2 at 12288 bins", [kinds[j] for j in range(2)],
                            12288)]))
    for n, seed, ladders in cases:
        xi = int_sparse_data(1, n, seed)[0]
        wi = int_weights((n,), seed + 1)
        for label, ladder, nbins in ladders:
            e = edge_ladders(ref, ladder, nbins)
            for xdt in (torch.float32, torch.bfloat16):
                x = xi.to(xdt)
                c3s.exact(cpo.cp_histogram_multi(x, e, want_sums=True),
                          ref.cp_histogram_multi_ref(x, e, want_sums=True),
                          f"n={n} {xdt} {label}")
            for xdt, wdt in WDTYPES:
                x, w = xi.to(xdt), wi.to(wdt)
                c3ws.exact(cpo.wcp_histogram_multi(x, w, e, want_sums=True),
                           ref.wcp_histogram_multi_ref(x, w, e,
                                                       want_sums=True),
                           f"n={n} {xdt} {wdt} {label}")
        if n == N_ODD:
            for kind in kinds:  # K = 1 through the scalar views
                e1 = edge_ladders(ref, [kind], 128)[0]
                c3s.exact(cpo.cp_histogram(xi, e1, want_sums=True),
                          ref.cp_histogram_ref(xi, e1, want_sums=True),
                          f"n={n} K=1 {kind}")
                c3ws.exact(cpo.wcp_histogram(xi, wi, e1, want_sums=True),
                           ref.wcp_histogram_ref(xi, wi, e1, want_sums=True),
                           f"n={n} K=1 {kind}")
        del xi, wi
        x = special_data(1, n, seed + 2)[0]
        wd = dense_weights(n, seed + 3)
        plain = ref.wcp_histogram_multi_ref
        for label, ladder, nbins in ladders:
            e = edge_ladders(ref, ladder, nbins)
            got = cpo.cp_histogram_multi(x, e, want_sums=True)
            c3s.near(got[1], *f64_sums(plain, x, None, e), got[0],
                     sums_chain(cpo, n, nbins + 1, 1), f"n={n} {label}")
            got = cpo.wcp_histogram_multi(x, wd, e, want_sums=True)
            c3ws.near(got[2], *f64_sums(plain, x, wd, e), got[0],
                      sums_chain(cpo, n, nbins + 1, 2), f"n={n} {label}")
            c3s.repeat(lambda: cpo.cp_histogram_multi(x, e, want_sums=True),
                       f"n={n} {label}")
            c3ws.repeat(lambda: cpo.wcp_histogram_multi(x, wd, e,
                                                        want_sums=True),
                        f"n={n} {label}")
        del x, wd
    ident = sums_ladders_alone_equal_among_16(cpo, ref, sel, obj)
    log(f"K3s/K3ws hist_multi_sums sums legs == plain version: counts, "
        f"masses and sums bit for bit on integer data with inf/NaN/±0 at "
        f"n=2^27 K=16 (identical and cycled ladders), n={N_ODD} K=64, K=3 at "
        f"8192 bins, K=2 at 12288 bins (the grouped design) and K=1 "
        f"(cp_histogram / "
        f"wcp_histogram), x and w each f32 and bf16; randn sums within "
        f"{c3s.bound:.3g} of f64 (worst {c3s.rel:.3g} / {c3ws.rel:.3g}), two "
        f"launches identical; at n={N_IDENT} with dense weights a ladder "
        f"alone and the 16 permuted == its entry among 16: "
        f"{json.dumps(ident)}")
    return ({**c3s.result(), "alone_equals_among_16": {
                k.split(" ", 1)[1]: v for k, v in ident.items()
                if k.startswith("k3s ")}},
            {**c3ws.result(), "alone_equals_among_16": {
                k.split(" ", 1)[1]: v for k, v in ident.items()
                if k.startswith("k3ws ")}})


def polish_path(sel, cpo) -> dict:
    """``method='binned_polish'`` on every leg at full size: only the sums
    legs may launch, one launch per sweep, every value against its
    oracle."""
    total = dict.fromkeys(cpo.LAUNCHES, 0)

    def add(launches):
        for k, v in launches.items():
            total[k] += v

    def equal_to(want):
        def check(res):
            if not torch.equal(res.value.float().reshape(-1),
                               want.float().reshape(-1)):
                raise AssertionError("value differs from the oracle")
        return check

    x = torch.randn(N_BIG, generator=gen(131), device=DEVICE)
    xs = torch.sort(x).values
    k_med = (N_BIG + 1) // 2
    add(drive_only(sel, cpo, "median n=2^27 f32 (binned_polish)",
                   lambda: sel.median(x, method="binned_polish"),
                   equal_to(xs[k_med - 1]), "cp_histogram_batched_sums"))
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE).long()
    add(drive_only(sel, cpo, "quantiles K=16 n=2^27 f32 (binned_polish)",
                   lambda: sel.quantiles(x, QS16, method="binned_polish"),
                   equal_to(xs[ks - 1]), "cp_histogram_multi_sums"))
    del xs
    xb = x.to(torch.bfloat16)
    add(drive_only(sel, cpo, "median n=2^27 bf16 (binned_polish)",
                   lambda: sel.median(xb, method="binned_polish"),
                   equal_to(torch.sort(xb).values[k_med - 1]),
                   "cp_histogram_batched_sums"))
    del xb

    xr = torch.randn((ROWS, N_ROW), generator=gen(132), device=DEVICE)
    kr = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(133),
                       device=DEVICE)
    want = torch.gather(torch.sort(xr, dim=1).values, 1,
                        (kr - 1)[:, None])[:, 0]
    add(drive_only(sel, cpo, "select_rows (64, 2^20) per-row k "
                   "(binned_polish)",
                   lambda: sel.select_rows(xr, kr, method="binned_polish"),
                   equal_to(want), "cp_histogram_batched_sums"))
    del xr

    w01 = (torch.rand(N_BIG, generator=gen(134), device=DEVICE)
           < 1 / 16).float()
    W01 = float(w01.sum())
    assert W01 < EXACT_TOTAL
    xs, cum = sorted_mass(x, w01)
    add(drive_only(sel, cpo, "weighted_median n=2^27, 0/1 weights "
                   "(binned_polish)",
                   lambda: sel.weighted_median(x, w01, method="binned_polish"),
                   equal_to(mass_oracle(xs, cum, 0.5 * W01)),
                   "wcp_histogram_batched_sums"))
    wks16 = torch.tensor(QS16 * W01, dtype=torch.float32)
    add(drive_only(sel, cpo, "weighted_quantiles K=16 n=2^27, 0/1 weights "
                   "(binned_polish)",
                   lambda: sel.weighted_quantiles(x, w01, QS16,
                                                  method="binned_polish"),
                   equal_to(mass_oracle(xs, cum, wks16)),
                   "wcp_histogram_multi_sums"))
    del xs, cum, w01
    wd = dense_weights(N_BIG, 135)
    in_interval, margins = mass_interval(cpo, x, wd)
    add(drive_only(sel, cpo, "weighted_median n=2^27, dense weights "
                   "(binned_polish)",
                   lambda: sel.weighted_median(x, wd, method="binned_polish"),
                   in_interval, "wcp_histogram_batched_sums"))
    log(f"  polished dense-weight median mass interval: "
        f"{json.dumps(margins)}")
    return total


def warm_path(sel, cpo, stream) -> dict:
    """Warm starts at full size: an unchanged prior, a tracked stream and
    the cp leg's first pivot."""
    out = {}
    x = torch.randn(N_BIG, generator=gen(141), device=DEVICE)
    k = int(sel.ranks_from_quantiles(0.5, N_BIG))
    cold = sel.median(x)
    cpo.reset_launches()
    warm = sel.median(x, prior=cold)
    torch.cuda.synchronize()
    launched = {kk: v for kk, v in cpo.LAUNCHES.items() if v}
    if not (int(warm.iters) == 1 and int(warm.status) == sel.EXACT_HIT
            and launched == {"cp_histogram_batched": 1, "row_sums": 1,
                             "sum_blocks": 1}
            and float(warm.value) == float(cold.value)
            == float(torch.sort(x).values[(N_BIG + 1) // 2 - 1])):
        raise AssertionError(f"median with an unchanged prior: iters "
                             f"{int(warm.iters)} status {int(warm.status)} "
                             f"launches {launched}")
    log(f"median n=2^27 with prior=cold on unchanged x: 1 sweep, EXACT_HIT, "
        f"launches {launched}")

    # a sliding-window sensor feed: each tick replaces 2^-10 of the
    # elements, chosen by a seeded generator, with fresh draws, in place
    g = gen(142)
    w01 = (torch.rand(N_BIG, generator=gen(143), device=DEVICE)
           < 1 / 16).float()
    tracker = stream.QuantileTracker(0.5)
    statuses, launches = [], dict.fromkeys(cpo.LAUNCHES, 0)
    wprior, wsweeps = None, []
    for tick in range(8):
        if tick:
            idx = torch.randint(0, N_BIG, (N_BIG >> 10,), generator=g,
                                device=DEVICE)
            x[idx] = torch.randn(N_BIG >> 10, generator=g, device=DEVICE)
        prior_before = tracker.prior
        cpo.reset_launches()
        res = tracker.update(x)
        torch.cuda.synchronize()
        for kk, v in cpo.LAUNCHES.items():
            launches[kk] += v
        statuses.append(int(res.status))
        if float(res.value) != float(torch.sort(x).values[k - 1]):
            raise AssertionError(f"tracker tick {tick}: value differs from "
                                 f"torch.sort")
        # reselect with weights on the same stream
        xs, cum = sorted_mass(x, w01)
        wk = 0.5 * float(cum[-1])
        wres, wprior = stream.reselect(x, wk, weights=w01, prior=wprior)
        wsweeps.append(int(wres.iters))
        if float(wres.value) != float(mass_oracle(xs, cum, wk)[0]):
            raise AssertionError(f"reselect tick {tick}: value differs from "
                                 f"the sort + f64 cumulative-mass oracle")
        del xs, cum
    sweeps = tracker.sweeps
    if sel.NOT_CONVERGED in statuses or any(s != 1 for s in sweeps[1:]):
        raise AssertionError(f"tracker: sweeps {sweeps} statuses {statuses}")
    log(f"QuantileTracker(0.5) over 8 ticks of a 2^27 stream (2^-10 "
        f"replaced per tick): sweeps {sweeps} statuses {statuses}; "
        f"weighted reselect sweeps {wsweeps}; launches "
        f"{ {kk: v for kk, v in launches.items() if v} }")
    out.update(tracker_sweeps=sweeps, tracker_statuses=statuses,
               reselect_weighted_sweeps=wsweeps)

    xsmall = x[:N_SMALL].contiguous()
    k_s = N_SMALL // 3
    cold_s = sel.order_statistic(xsmall, k_s, method="cp")
    cpo.reset_launches()
    warm_s = sel.order_statistic(xsmall, k_s, method="cp", prior=cold_s)
    torch.cuda.synchronize()
    want = float(torch.sort(xsmall).values[k_s - 1])
    if not (float(warm_s.value) == float(cold_s.value) == want
            and int(warm_s.iters) == 1
            and int(warm_s.status) == sel.EXACT_HIT):
        raise AssertionError(f"cp warm start: iters {int(warm_s.iters)} "
                             f"status {int(warm_s.status)}")
    log(f"order_statistic n={N_SMALL} method=cp prior=cold: 1 pass "
        f"(cold {int(cold_s.iters)}), EXACT_HIT, launches "
        f"{ {kk: v for kk, v in cpo.LAUNCHES.items() if v} }")

    # kept for the timings: the last tick's data and the prior before it
    out["_tick"] = (x, prior_before)
    return out


def sums_timings(sel, cpo, ref, obj, tick) -> dict:
    """The sums legs beside their bounds, their no-sums twins and their
    plain versions; polished answers against 'binned'; a warm tracker
    tick against a cold median on the same data."""
    out = {}
    x = torch.randn(N_BIG, generator=gen(151), device=DEVICE)
    wd = dense_weights(N_BIG, 152)
    x2, w2 = x[None, :], wd[None, :]
    steps = 8  # ceil(log2(129))
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].contiguous()
    e3 = ref.bin_edges(torch.tensor(-1e-3, device=DEVICE),
                       torch.tensor(2e-3, device=DEVICE), 128)[None, :]
    fk = full_kw(cpo)
    cnt, _ = cpo.cp_histogram_batched(x2, e1)
    inside = int(N_BIG - cnt[0, 0] - cnt[0, -1])
    outs = 2 * cnt.numel() * 4
    k2 = torch.full((1,), (N_BIG + 1) // 2, device=DEVICE)
    ep = {"k1s": rows_polish_edges(sel, obj, x2, k2),
          "k1ws": rows_polish_edges(sel, obj, x2, 0.5 * w2.sum(dim=1), w2)}
    # the first sweep's ladder e1 holds every element (full_bracket), and
    # so does the polished one (the engine's only first sweep on these legs)
    for key, fn, plain, twin, nbytes, ops in (
            ("k1s", lambda e, **kw: cpo.cp_histogram_batched(
                x2, e, want_sums=True, **kw),
             lambda: ref.cp_histogram_batched_ref(x2, e1, want_sums=True),
             lambda: cpo.cp_histogram_batched(x2, e1, **fk),
             N_BIG * 4 + e1.numel() * 4 + outs,
             # compares and an end-slot add per element, a search and an
             # add inside
             3 * N_BIG + inside * (steps + 1)),
            ("k1ws", lambda e, **kw: cpo.wcp_histogram_batched(
                x2, w2, e, want_sums=True, **kw),
             lambda: ref.wcp_histogram_batched_ref(x2, w2, e1,
                                                   want_sums=True),
             lambda: cpo.wcp_histogram_batched(x2, w2, e1, **fk),
             N_BIG * 8 + e1.numel() * 4 + outs + cnt.numel() * 4,
             # + the product and a second add per element
             5 * N_BIG + inside * (steps + 2))):
        out[key] = dict(
            ms=cuda_ms(lambda: fn(e1, **fk), reps=20),
            polished_ms=cuda_ms(lambda: fn(ep[key], **fk), reps=20),
            narrow_ms=cuda_ms(lambda: fn(e3), reps=20),
            twin_ms=cuda_ms(twin, reps=20),
            plain_ms=cuda_ms(plain, reps=2, rounds=3),
            bound=bound(nbytes, ops))
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    e16 = e1.expand(16, -1).contiguous()
    cnt16, _ = cpo.cp_histogram_multi(x, e16)
    cum = torch.cumsum(cnt16[:, :-1], dim=-1, dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e16, e16[:, 0], e16[:, -1], ks)
    e2 = ref.bin_edges(yl, yr, 128).contiguous()
    cnt2, _ = cpo.cp_histogram_multi(x, e2)
    for label, e, c in (("first", e16, cnt16), ("narrow", e2, cnt2)):
        distinct = len({r.numpy().tobytes() for r in e.cpu()})
        out[f"k3s_{label}"] = dict(
            ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, e, want_sums=True),
                       reps=20),
            twin_ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, e), reps=20),
            plain_ms=cuda_ms(lambda: ref.cp_histogram_multi_ref(
                x, e, want_sums=True), reps=1, rounds=3),
            bound=bound(*k3_sums_work(x, e, c)),
            distinct_ladders=distinct)
        out[f"k3ws_{label}"] = dict(
            ms=cuda_ms(lambda: cpo.wcp_histogram_multi(x, wd, e,
                                                       want_sums=True),
                       reps=20),
            twin_ms=cuda_ms(lambda: cpo.wcp_histogram_multi(x, wd, e),
                            reps=20),
            plain_ms=cuda_ms(lambda: ref.wcp_histogram_multi_ref(
                x, wd, e, want_sums=True), reps=1, rounds=3),
            bound=bound(*k3_sums_work(x, e, c, wd)),
            distinct_ladders=distinct)

    # the polished multi-k first sweep: every target's ladder spans
    # [min, max] but centres half its edges on its own seed cut, so the 16
    # ladders are distinct and every element lies inside all 16 (K3ws: the
    # weighted seed cuts of 16 target masses)
    W = float(wd.double().sum())
    wks = torch.tensor(QS16 * W, dtype=torch.float32, device=DEVICE)
    out.update(k3_polish_first_times(sel, obj, cpo, x, ks, wd, wks))
    out.update(polish_multi_times(sel, obj, x, ks, reps=3))

    # polished answers against 'binned', with sweeps per answer
    xr = torch.randn((ROWS, N_ROW), generator=gen(153), device=DEVICE)
    kr = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(154),
                       device=DEVICE)
    for label, call in (
            ("median", lambda m: sel.median(x, method=m)),
            ("rows", lambda m: sel.select_rows(xr, kr, method=m))):
        for m in ("binned", "binned_polish"):
            tag = f"{label}_{'polish' if m == 'binned_polish' else 'binned'}"
            out[f"{tag}_ms"] = cuda_ms(lambda: call(m), reps=1, rounds=5)
            out[f"{tag}_sweeps"] = int(call(m).iters.max())
    del xr

    # one warm tracker tick against a cold median on the same tick's data
    xt, prior = tick
    k = int(sel.ranks_from_quantiles(0.5, N_BIG))
    out["tick_warm_ms"] = cuda_ms(lambda: sel.quantile(xt, 0.5, prior=prior),
                                  reps=1, rounds=5)
    out["tick_cold_ms"] = cuda_ms(lambda: sel.quantile(xt, 0.5), reps=1,
                                  rounds=5)
    cap = sel._default_cap(N_BIG)
    for tag, pr in (("tick_warm", prior), ("tick_cold", None)):
        ev = obj.RowsEvaluator(xt[None, :], k)
        out[f"{tag}_stats_ms"] = cuda_ms(ev.init_stats, reps=1, rounds=5)
        out[f"{tag}_loop_ms"] = cuda_ms(lambda: sel.binned_loop_batched(
            ev, nbins=128, cap=cap, prior=pr), reps=1, rounds=5)
        s, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cap,
                                                prior=pr)
        out[f"{tag}_finalize_ms"] = cuda_ms(lambda: sel._finalize_rows(
            xt[None, :], ev.k, s, cap, xmin, xmax), reps=1, rounds=5)
        out[f"{tag}_sweeps"] = int(s.iters.max())
        out[f"{tag}_certified"] = bool(s.found_exact.all())
    return out


def k3_polish_first_times(sel, obj, cpo, x, ks, wd, wks, reps=5) -> dict:
    """K3s and K3ws on the polished first sweep of 16 targets of ``x``
    (``polish_first_edges``; K3ws with dense weights ``wd`` and target
    masses ``wks``): ms, their no-sums twins (K3, K3w), their bounds."""
    out = {}
    for key, e, call, twin, w in (
            ("k3s_polish_first", polish_first_edges(sel, obj, x, ks),
             lambda e: cpo.cp_histogram_multi(x, e, want_sums=True),
             lambda e: cpo.cp_histogram_multi(x, e), None),
            ("k3ws_polish_first", polish_first_edges(sel, obj, x, wks, wd),
             lambda e: cpo.wcp_histogram_multi(x, wd, e, want_sums=True),
             lambda e: cpo.wcp_histogram_multi(x, wd, e), wd)):
        cnt, _ = cpo.cp_histogram_multi(x, e)
        distinct = len({r.numpy().tobytes() for r in e.cpu()})
        out[key] = dict(ms=cuda_ms(lambda: call(e), reps=reps),
                        twin_ms=cuda_ms(lambda: twin(e), reps=reps),
                        bound=bound(*k3_sums_work(x, e, cnt, w)),
                        distinct_ladders=distinct)
    return out


def rows_sums_ladders(sel, obj, ref, x, w=None) -> dict:
    """The ladders K1s (K1ws with dense weights ``w``) meets on ``x``
    (B, n), 128 bins, as label -> (edges, full_bracket): the polished first
    sweep's (``rows_polish_edges`` for each row's median rank or half its
    mass: the engine's only first sweep on these legs), the uniform first
    sweep's (``bin_edges`` over each row's [min, max]) and a narrow one,
    (-1e-3, 2e-3]."""
    rows, n = x.shape
    k = (torch.full((rows,), (n + 1) // 2, device=DEVICE) if w is None
         else (0.5 * w.double().sum(dim=1)).float())
    return {"polished": (rows_polish_edges(sel, obj, x, k, w), True),
            "uniform": (ref.bin_edges(x.amin(1), x.amax(1), 128)
                        .contiguous(), True),
            "narrow": (ref.bin_edges(
                torch.full((rows,), -1e-3, device=DEVICE),
                torch.full((rows,), 2e-3, device=DEVICE), 128)
                .contiguous(), False)}


def rows_sums_call(cpo, x, w, e, full, design=None):
    """One K1s (``w`` None) or K1ws call through its wrapper, or, with
    ``design``, through ``_hist_rows`` in that design."""
    if design is not None:
        key = ("cp" if w is None else "wcp") + "_histogram_batched_sums"
        return cpo._hist_rows(x, w, e, True, key, full, design=design)
    if w is None:
        return cpo.cp_histogram_batched(x, e, want_sums=True,
                                        **full_kw(cpo, full))
    return cpo.wcp_histogram_batched(x, w, e, want_sums=True,
                                     **full_kw(cpo, full))


def rows_sums_designs(cpo) -> tuple:
    """The designs ``_hist_rows`` can be asked for by name (none on a tree
    whose ``_hist_rows`` takes no ``design``)."""
    if "design" not in inspect.signature(cpo._hist_rows).parameters:
        return ()
    return cpo.ROWS_SUMS_DESIGNS


def rows_sums_times(sel, obj, cpo, ref, reps=20) -> dict:
    """K1s and K1ws (dense f32 w) through their wrappers at (1, 2^27) and
    (64, 2^20) f32 on the three ladders of ``rows_sums_ladders``, and on
    first sweeps in each design a tree can be asked for; K1 on a warm
    tick's ``prior_edges`` ladder beside the uniform one at (1, 2^27):
    ms by "leg/shape/ladder[/design]", and each leg's bytes bound by
    "leg/shape/bound"."""
    out = {}
    for shape, (rows, n), seed in (("1x2^27", (1, N_BIG), 161),
                                   ("64x2^20", (ROWS, N_ROW), 162)):
        x = torch.randn((rows, n), generator=gen(seed), device=DEVICE)
        wd = dense_weights((rows, n), seed + 1)
        for leg, w in (("k1s", None), ("k1ws", wd)):
            nrows = 1 if w is None else 2
            for label, (e, full) in rows_sums_ladders(sel, obj, ref, x,
                                                      w).items():
                out[f"{leg}/{shape}/{label}"] = cuda_ms(
                    lambda: rows_sums_call(cpo, x, w, e, full), reps=reps)
                for design in (rows_sums_designs(cpo) if full else ()):
                    out[f"{leg}/{shape}/{label}/{design}"] = cuda_ms(
                        lambda: rows_sums_call(cpo, x, w, e, full, design),
                        reps=reps)
            nbytes = (x.numel() * (4 if w is None else 8) + rows * 129 * 4
                      + rows * 130 * 4 * (1 + nrows))
            out[f"{leg}/{shape}/bound"] = nbytes / HBM_BYTES_PER_S * 1e3
        if rows == 1:
            cold = sel.median(x[0])
            ep = rows_prior_edges(sel, obj, x, (n + 1) // 2, cold)
            eu = ref.bin_edges(x.amin(1), x.amax(1), 128).contiguous()
            for label, e in (("prior", ep), ("uniform", eu)):
                out[f"k1/{shape}/{label}"] = cuda_ms(
                    lambda: cpo.cp_histogram_batched(x, e, **full_kw(cpo)),
                    reps=reps)
        del x, wd
    return out


def polish_rows_times(sel, obj, reps=5) -> dict:
    """The row histogram's polished answers end to end: ``median`` of 2^27
    f32, ``weighted_median`` with dense weights, ``select_rows`` on
    (64, 2^20) with per-row k, each 'binned_polish' (and its 'binned'
    twin): ms, sweeps, and the stats pass, the loop (stats pass included)
    and the finalize."""
    x = torch.randn(N_BIG, generator=gen(8), device=DEVICE)
    wd = dense_weights(N_BIG, 92)
    xr = torch.randn((ROWS, N_ROW), generator=gen(9), device=DEVICE)
    ks = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(10),
                       device=DEVICE)
    cap, cap_rows = sel._default_cap(N_BIG), sel._default_cap_rows(N_ROW)
    k_med = (N_BIG + 1) // 2
    cases = (
        ("median", lambda m: sel.median(x, method=m),
         lambda: obj.RowsEvaluator(x[None], k_med), cap),
        ("weighted_median_dense",
         lambda m: sel.weighted_median(x, wd, method=m),
         lambda: obj.RowsEvaluator(x[None], 0.5 * wd.sum(),
                                   weights=wd[None]), cap),
        ("select_rows", lambda m: sel.select_rows(xr, ks, method=m),
         lambda: obj.RowsEvaluator(xr, ks), cap_rows))
    out = {}
    for label, call, make, cp in cases:
        for tag, m in (("binned", "binned"), ("polish", "binned_polish")):
            key = f"{label}_{tag}"
            out[f"{key}_ms"] = cuda_ms(lambda: call(m), reps=1, rounds=reps)
            out[f"{key}_sweeps"] = int(call(m).iters.max())
            if tag == "binned":
                continue
            out[f"{key}_stats_ms"] = cuda_ms(lambda: make().init_stats(),
                                             reps=1, rounds=reps)
            ev = make()
            out[f"{key}_loop_ms"] = cuda_ms(lambda: sel.binned_loop_batched(
                ev, nbins=128, cap=cp, polish=True), reps=1, rounds=reps)
            st, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cp,
                                                     polish=True)
            w = {"w": ev.w.to(ev.k.dtype)} if ev.weighted else {}
            out[f"{key}_finalize_ms"] = cuda_ms(lambda: sel._finalize_rows(
                ev.x, ev.k, st, cp, xmin, xmax, **w), reps=1, rounds=reps)
            del ev, st
    return out


def polish_multi_times(sel, obj, x, ks, reps=3) -> dict:
    """16 ``quantiles`` of ``x`` and 16 ``weighted_quantiles`` with 0/1
    weights at density 1/16 (every mass exact), 'binned' against
    'binned_polish': ms end to end, sweeps, and the loop (the stats pass
    included) and the shared finalize."""
    out = {}
    w01 = (torch.rand(x.numel(), generator=gen(155), device=DEVICE)
           < 1 / 16).float()
    wks = torch.tensor(QS16 * float(w01.sum()), dtype=torch.float32,
                       device=DEVICE)
    cap = sel._default_cap_rows(x.numel())
    for label, call, make in (
            ("quantiles", lambda m: sel.quantiles(x, QS16, method=m),
             lambda: obj.SharedEvaluator(x, ks)),
            ("wquantiles",
             lambda m: sel.weighted_quantiles(x, w01, QS16, method=m),
             lambda: obj.SharedEvaluator(x, wks, weights=w01))):
        for tag, m in (("binned", "binned"), ("polish", "binned_polish")):
            out[f"{label}_{tag}_ms"] = cuda_ms(lambda: call(m), reps=1,
                                               rounds=reps)
            res = call(m)
            out[f"{label}_{tag}_sweeps"] = int(res.iters.max())
            out[f"{label}_{tag}_not_converged"] = int(
                (res.status == sel.NOT_CONVERGED).sum())
            ev = make()
            out[f"{label}_{tag}_loop_ms"] = cuda_ms(
                lambda: sel.binned_loop_batched(ev, nbins=128, cap=cap,
                                                polish=m != "binned"),
                reps=1, rounds=reps)
            st, xmin, xmax = sel.binned_loop_batched(
                ev, nbins=128, cap=cap, polish=m != "binned")
            w = {"w": ev.w.to(ev.k.dtype)} if ev.weighted else {}
            out[f"{label}_{tag}_finalize_ms"] = cuda_ms(
                lambda: sel._finalize_shared(ev.x, ev.k, st, cap, xmin,
                                             xmax, **w), reps=1, rounds=reps)
            del ev, st
    return out


@functools.cache
def lane_ops_per_s() -> float:
    """The card's f32 lane rate, one operation per lane and clock: SMs x
    LANES_PER_SM x the maximum SM clock (``nvidia-smi``).  It is also the
    issue rate of SASS instructions counted per lane."""
    mhz = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.split()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * LANES_PER_SM * float(mhz) * 1e6


def bound(nbytes, ops):
    """The least time for ``nbytes`` of traffic and ``ops`` f32 operations
    (one lane each), and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / lane_ops_per_s() * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def timings(sel, cpo, ref, obj) -> dict:
    out = {}
    x = torch.randn((1, N_BIG), generator=gen(8), device=DEVICE)
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].contiguous()
    # K1 at the first sweep's full-data bracket (every element in bracket)
    fk = full_kw(cpo)
    k1 = cuda_ms(lambda: cpo.cp_histogram_batched(x, e1, **fk), reps=20)
    k1_plain = cuda_ms(lambda: ref.cp_histogram_batched_ref(
        x, e1, want_sums=False), reps=2, rounds=3)
    cnt, _ = cpo.cp_histogram_batched(x, e1)
    inside = int(N_BIG - cnt[0, 0] - cnt[0, -1])
    k1_bytes = x.numel() * 4 + e1.numel() * 4 + cnt.numel() * 4
    k1_ops = 2 * N_BIG + inside * math.ceil(math.log2(e1.shape[1]))
    lo, hi = float(e1[0, 0]), float(e1[0, -1])
    histc = cuda_ms(lambda: torch.histc(x, bins=128, min=lo, max=hi), reps=5)
    # K1 at a narrow later-sweep bracket (nearly every element outside)
    e3 = ref.bin_edges(torch.tensor(-1e-3, device=DEVICE),
                       torch.tensor(2e-3, device=DEVICE), 128)[None, :]
    k1_narrow = cuda_ms(lambda: cpo.cp_histogram_batched(x, e3), reps=20)
    y = torch.zeros(1, device=DEVICE)
    k2 = cuda_ms(lambda: cpo.cp_partials_batched(x, y), reps=20)
    k2_plain = cuda_ms(lambda: ref.cp_partials_batched_ref(x, y), reps=2,
                       rounds=3)
    k2_bytes = x.numel() * 4 + 4 + cpo.fg_blocks(N_BIG) * 16
    k2_ops = 7 * N_BIG

    out["k1"] = dict(ms=k1, plain_ms=k1_plain, bound=bound(k1_bytes, k1_ops),
                     narrow_ms=k1_narrow, histc_ms=histc)
    out["k2"] = dict(ms=k2, plain_ms=k2_plain, bound=bound(k2_bytes, k2_ops))

    # rows shape (64, 2^20): the lts_fit-shaped batch
    xr = torch.randn((ROWS, N_ROW), generator=gen(9), device=DEVICE)
    er = ref.bin_edges(xr.amin(1), xr.amax(1), 128).contiguous()
    yr = torch.zeros(ROWS, device=DEVICE)
    out["k1_rows_ms"] = cuda_ms(lambda: cpo.cp_histogram_batched(
        xr, er, **fk), reps=20)
    out["k2_rows_ms"] = cuda_ms(lambda: cpo.cp_partials_batched(xr, yr),
                                reps=20)
    out["rows_bound_ms"] = xr.numel() * 4 / HBM_BYTES_PER_S * 1e3

    # end to end
    xv = x[0]
    k_med = (N_BIG + 1) // 2
    out["median_ms"] = cuda_ms(lambda: sel.median(xv), reps=1, rounds=5)
    out["kthvalue_ms"] = cuda_ms(lambda: torch.kthvalue(xv, k_med), reps=1,
                                 rounds=5)
    out["sort_ms"] = cuda_ms(lambda: torch.sort(xv), reps=1, rounds=5)
    out["median_cp_ms"] = cuda_ms(
        lambda: sel.order_statistic(xv, k_med, method="cp"), reps=1,
        rounds=3)
    ks = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(10),
                       device=DEVICE)
    out["rows_ms"] = cuda_ms(lambda: sel.select_rows(xr, ks), reps=1,
                             rounds=5)
    out["rows_sort_ms"] = cuda_ms(lambda: torch.sort(xr, dim=1), reps=1,
                                  rounds=5)

    # where the time goes: the stats pass, the sweep loop (which includes
    # the stats pass) and the finalize, for the median and the rows batch
    for label, xm, k, cap in (
            ("median", xv[None, :], k_med, sel._default_cap(N_BIG)),
            ("rows", xr, ks, sel._default_cap_rows(N_ROW))):
        ev = obj.RowsEvaluator(xm, k)
        out[f"{label}_stats_ms"] = cuda_ms(ev.init_stats, reps=1, rounds=5)
        out[f"{label}_loop_ms"] = cuda_ms(lambda: sel.binned_loop_batched(
            ev, nbins=128, cap=cap), reps=1, rounds=5)
        s, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cap)
        out[f"{label}_finalize_ms"] = cuda_ms(lambda: sel._finalize_rows(
            xm, ev.k, s, cap, xmin, xmax), reps=1, rounds=5)
        out[f"{label}_sweeps"] = int(s.iters.max())
    return out


def k3_work(x, edges, cnt):
    """Bytes and operations that binning ``x`` against ``edges`` needs on
    this data: one read of x, and per element and DISTINCT ladder two
    compares, plus a binary search for each in-bracket element."""
    nbytes = (x.numel() * x.element_size() + edges.numel() * 4
              + cnt.numel() * 4)
    inside = {}  # in-bracket count per distinct ladder
    for e, c in zip(edges.cpu(), cnt.cpu()):
        inside.setdefault(e.numpy().tobytes(), x.numel() - int(c[0] + c[-1]))
    steps = math.ceil(math.log2(edges.shape[1]))
    return nbytes, (2 * x.numel() * len(inside)
                    + sum(inside.values()) * steps)


def k3_sums_work(x, edges, cnt, w=None):
    """Bytes and operations that K3s (K3ws with ``w``) needs on this data:
    one read of x (and w), the edges, and the counts and the f32 rows out;
    per element and DISTINCT ladder the add of its count and the add of x
    to its slot's sum (K3ws: of w to its mass and of w*x to its sum), and
    for K3ws a product per element.  No search: which slot an element
    takes is the work of a design (the sorted tile finds it by sorting,
    shared by all ladders), not of the function."""
    nrows = 1 if w is None else 2
    n = x.numel()
    nbytes = (n * x.element_size() + edges.numel() * 4
              + cnt.numel() * 4 * (1 + nrows))
    distinct = len({e.numpy().tobytes() for e in edges.cpu()})
    ops = n * distinct * (1 + nrows)
    if w is not None:
        nbytes += n * w.element_size()
        ops += n
    return nbytes, ops


def k_sweep(sel, cpo, xs, x, w=None) -> dict:
    """K4 (K4w with ``w``) on the 2^27 elements of ``x`` at K in
    ``KS_SWEEP`` pivots, evenly spaced quantiles of ``xs`` (x sorted)."""
    out = {}
    for k in KS_SWEEP:
        yk = xs[sel.ranks_from_quantiles(np.arange(1, k + 1) / (k + 1),
                                         N_BIG).to(DEVICE).long() - 1]
        yk = yk.float().contiguous()
        if w is None:
            out[k] = cuda_ms(lambda: cpo.cp_partials_multi(x, yk), reps=10)
        else:
            out[k] = cuda_ms(lambda: cpo.wcp_partials_multi(x, w, yk),
                             reps=10)
    return out


def cp_solves(sel, obj) -> dict:
    """The two 16-target cutting-plane solves of 2^27 f32 end to end, each
    with its loop (stats pass included: one K4 or K4w pass per iteration
    for all targets), its shared finalize, its passes and its NOT_CONVERGED
    count: ``multi_order_statistic`` on the data of ``timings_multi``
    (``multi_cp``) and of ``multi_k_path`` (``multi_cp_main``), and
    ``weighted_multi_order_statistic`` with the 0/1 weights of
    ``weighted_timings`` (``wmulti_cp``) and of ``weighted_path``
    (``wmulti_cp_main``)."""
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    cap = sel._default_cap_rows(N_BIG)
    out = {}
    for label, xseed, wseed in (("multi_cp", 32, None),
                                ("multi_cp_main", 31, None),
                                ("wmulti_cp", 91, 93),
                                ("wmulti_cp_main", 81, 82)):
        x = torch.randn(N_BIG, generator=gen(xseed), device=DEVICE)
        if wseed is None:
            ev = obj.SharedEvaluator(x, ks)

            def call():
                return sel.multi_order_statistic(x, ks, method="cp")
        else:
            w01 = (torch.rand(N_BIG, generator=gen(wseed), device=DEVICE)
                   < 1 / 16).float()
            wks = torch.tensor(QS16 * float(w01.sum()), dtype=torch.float32,
                               device=DEVICE)
            ev = obj.SharedEvaluator(x, wks, weights=w01)

            def call():
                return sel.weighted_multi_order_statistic(x, w01, wks,
                                                          method="cp")
        out[f"{label}_ms"] = cuda_ms(call, reps=1, rounds=3)
        out[f"{label}_loop_ms"] = cuda_ms(lambda: sel.bracket_loop_batched(
            ev, method="cp", cap=cap), reps=1, rounds=3)
        s, xmin, xmax = sel.bracket_loop_batched(ev, method="cp", cap=cap)
        w = {"w": ev.w.to(ev.k.dtype)} if ev.weighted else {}
        out[f"{label}_finalize_ms"] = cuda_ms(lambda: sel._finalize_shared(
            ev.x, ev.k, s, cap, xmin, xmax, **w), reps=1, rounds=3)
        out[f"{label}_passes"] = int(s.iters.max())
        out[f"{label}_not_converged"] = int(
            (call().status == sel.NOT_CONVERGED).sum())
        del x, ev, s
    return out


def timings_multi(sel, cpo, ref, obj) -> dict:
    """K3 and K4 at K = 16 on n = 2^27, and the 16 quantiles end to end."""
    out = {}
    x = torch.randn(N_BIG, generator=gen(32), device=DEVICE)
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    # K3 at sweep 1: every target's bracket is [min, max], 16 identical
    # ladders, every element in bracket
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e1 = e1.contiguous()
    cnt1, _ = cpo.cp_histogram_multi(x, e1)
    # K3 at sweep 2: the 16 distinct narrow brackets that sweep 1 chose
    cum = torch.cumsum(cnt1[:, :-1], dim=-1, dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e1, e1[:, 0], e1[:, -1], ks)
    e2 = ref.bin_edges(yl, yr, 128).contiguous()
    cnt2, _ = cpo.cp_histogram_multi(x, e2)
    for label, e, cnt in (("k3_first", e1, cnt1), ("k3_narrow", e2, cnt2)):
        kw = k3_kw(cpo, label == "k3_first")  # the main path's design
        out[label] = dict(
            ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, e, **kw), reps=20),
            plain_ms=cuda_ms(lambda: ref.cp_histogram_multi_ref(
                x, e, want_sums=False), reps=1, rounds=3),
            bound=bound(*k3_work(x, e, cnt)),
            distinct_ladders=len({r.numpy().tobytes() for r in e.cpu()}))
    # K3's own kernel (the buckets) on the first sweep's ladders; the main
    # path runs K1's lane kernel on the one ladder there
    out["k3_first"]["general_kernel_ms"] = cuda_ms(
        lambda: cpo.cp_histogram_multi(x, e1), reps=20)
    # K4 at 16 pivots on the data's quantiles, and at K in KS_SWEEP
    xs = torch.sort(x).values
    y = xs[ks.long() - 1]
    nblk = cpo.fg_blocks(N_BIG)
    out["k4"] = dict(
        ms=cuda_ms(lambda: cpo.cp_partials_multi(x, y), reps=20),
        plain_ms=cuda_ms(lambda: ref.cp_partials_multi_ref(x, y), reps=1,
                         rounds=3),
        bound=bound(N_BIG * 4 + 16 * 4 + nblk * 16 * 16,
                    K4_OPS * 16 * N_BIG))
    out["k4_sweep_ms"] = k_sweep(sel, cpo, xs, x)
    del xs

    # end to end
    out["quantiles_ms"] = cuda_ms(lambda: sel.quantiles(x, QS16), reps=1,
                                  rounds=5)
    out["sort_gather_ms"] = cuda_ms(
        lambda: torch.sort(x).values[ks.long() - 1], reps=1, rounds=5)
    ks_host = [int(k) for k in ks.cpu()]
    out["sixteen_order_statistic_ms"] = cuda_ms(
        lambda: [sel.order_statistic(x, k) for k in ks_host], reps=1,
        rounds=3, warmup=1)

    # where the time goes: stats pass, sweep loop (which includes the stats
    # pass) and the shared finalize (16 sequential passes over x)
    ev = obj.SharedEvaluator(x, ks)
    cap = sel._default_cap_rows(N_BIG)
    out["quantiles_stats_ms"] = cuda_ms(ev.init_stats, reps=1, rounds=5)
    out["quantiles_loop_ms"] = cuda_ms(lambda: sel.binned_loop_batched(
        ev, nbins=128, cap=cap), reps=1, rounds=5)
    s, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cap)
    out["quantiles_finalize_ms"] = cuda_ms(lambda: sel._finalize_shared(
        ev.x, ev.k, s, cap, xmin, xmax), reps=1, rounds=5)
    out["quantiles_sweeps"] = int(s.iters.max())
    return out


_TYPES = {"f": "f32", "13__nv_bfloat16": "bf16"}


def fg_multi_instance(mangled: str):
    """The mangled name of ``fg_multi_kernel<T, W, G>`` -> "T/W/G" (W "-"
    on the counting leg), or None for another function."""
    m = re.search(r"fg_multi_kernelI(f|13__nv_bfloat16)"
                  r"(N\w*9NoWeightsE|f|13__nv_bfloat16|S\w*_)Li(\d+)EE",
                  mangled)
    if not m:
        return None
    t, w, g = m.groups()
    w = t if w.startswith("S") else w  # a substitution repeats T
    w = "-" if "NoWeights" in w else _TYPES[w]
    return f"{_TYPES[t]}/{w}/{g}"


def hist_batched_instance(mangled: str):
    """The mangled name of a ``hist_batched.cu`` kernel -> "name T/W/leg"
    (lane_rows_kernel legs 1 K1w, 2 K1s; lane_sums_kernel legs 1 K1s, 2
    K1ws; whist_batched_kernel legs 0 K1w, 1 K1s, 2 K1ws; W is T and leg
    "-" where the kernel has none), or None for another function."""
    m = re.search(r"\d+(lane_count_kernel|lane_rows_kernel|lane_sums_kernel|"
                  r"whist_batched_kernel|hist_batched_kernel)"
                  r"I(f|13__nv_bfloat16)"
                  r"(f|13__nv_bfloat16|S\w*?_)?(?:Li(\d)E)?(?:Li\dE)?E",
                  mangled)
    if not m:
        return None
    name, t, w, leg = m.groups()
    w = t if w is None or w.startswith("S") else w
    return f"{name} {_TYPES[t]}/{_TYPES[w]}/{leg or '-'}"


def ptxas_report(text: str, instance=fg_multi_instance) -> dict:
    """Registers and spill bytes per kernel instance (``instance`` maps a
    mangled name to its label, or None to skip it), from the ``-Xptxas
    -v`` output of a build."""
    rows, entry = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = instance(m.group(1))
            if entry:
                rows[entry] = {}
        elif entry and "spill stores" in line:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            rows[entry]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        elif entry and "Used" in line and "registers" in line:
            rows[entry]["registers"] = int(re.search(
                r"Used (\d+) registers", line).group(1))
    return rows


_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"(.*?);")


def sass_loops(so: Path) -> dict:
    """Per fg_multi kernel instance: the loops of its SASS (``cuobjdump
    -sass``; backward branches, to a label or to an address), largest
    first, each as (instructions in the body, opcode counts)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    res = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                         text=True, timeout=300, check=True)
    funcs, cur = {}, None
    for line in res.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is None:
            continue
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            cur.append(("label", m.group(1)))
            continue
        m = _INSN.search(line)
        if m:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    out = {}
    for fname, items in funcs.items():
        inst = fg_multi_instance(fname)
        if inst is None:
            continue
        targets, insns, pending = {}, [], []
        for it in items:
            if it[0] == "label":
                pending.append(it[1])
                continue
            for lab in pending + [it[0]]:
                targets[lab] = len(insns)
            pending = []
            insns.append(it)
        loops = []
        for j, (_, op, rest) in enumerate(insns):
            if not op.startswith("BRA"):
                continue
            m = re.search(r"\((\.L_x_\d+)\)|(0x[0-9a-f]+)", rest)
            if not m:
                continue
            start = targets.get(m.group(1) or int(m.group(2), 16))
            if start is None or start > j:
                continue
            body = [o.split(".")[0] for _, o, _ in insns[start:j + 1]
                    if o != "NOP"]
            counts = {}
            for o in body:
                counts[o] = counts.get(o, 0) + 1
            loops.append((len(body), dict(sorted(
                counts.items(), key=lambda kv: -kv[1]))))
        out[inst] = sorted(loops, key=lambda lp: -lp[0])
    return out


def sass_g16(lib: Path) -> dict:
    """Per G = 16 fg_multi instance: its largest loops, and for each
    unrolled main loop (one per path, the tail loop left out) the batch U
    it loads (U elements, and U weights) and its SASS instructions per
    (element, pivot), body / (16 U)."""
    out = {}
    for inst, lps in sass_loops(lib).items():
        if not inst.endswith("/16") or not lps:
            continue
        main = [lp for lp in lps if lp[0] >= lps[0][0] // 2]
        per_load = 1 if "/-/" in inst else 2
        unroll = [max(1, ops.get("LDG", 0) // per_load) for _, ops in main]
        out[inst] = {"loops": [n for n, _ in lps[:4]], "unroll": unroll,
                     "per_element_pivot": [n / (u * 16) for (n, _), u in
                                           zip(main, unroll)],
                     "main_loop_ops": [ops for _, ops in main]}
    return out


def fg_multi_build(_build) -> dict:
    """Registers and spills (ptxas; only when this process built the
    library) and SASS instructions per (element, pivot) of the G = 16 f32
    instances of K4 and K4w, and the issue bound at K = 16, n = 2^27: the
    finite-pivot path's count (the path the timings take) over the lane
    rate."""
    regs = ptxas_report(_build.build_log.get("fg_multi", ""))
    sass = sass_g16(_build.library_path("fg_multi"))
    out = {}
    for key, inst in (("k4", "f32/-/16"), ("k4w", "f32/f32/16")):
        per = sass[inst]["per_element_pivot"]
        out[key] = {
            **regs.get(inst, {}),
            "sass_per_element_pivot": {"general": max(per),
                                       "finite_pivots": min(per)},
            "sass_main_loop_ops": sass[inst]["main_loop_ops"],
            "issue_bound_ms": min(per) * 16 * N_BIG / lane_ops_per_s()
            * 1e3}
    return out


def hist_batched_build(_build, cpo) -> dict:
    """K1's build report: registers and spills of each ``hist_batched.cu``
    instance (ptxas; only when this process built the library), and per
    lane-private leg at 128 bins its shared bytes a block and the blocks
    an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; a
    tree without the lane-private design reports none)."""
    out = {"ptxas": ptxas_report(_build.build_log.get("hist_batched", ""),
                                 hist_batched_instance)}
    lib = _build.load("hist_batched")
    if hasattr(cpo, "lane_hist_smem") and hasattr(lib,
                                                  "lane_hist_blocks_per_sm"):
        fn = lib.lane_hist_blocks_per_sm
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        column = hasattr(cpo, "lane_sums_smem")  # K1s/K1ws lane-column
        legs = [(0, "k1", 0), (1, "k1w", 1)] + (
            [(2, "k1s", 1), (3, "k1ws", 2)] if column else [(2, "k1s", 1)])
        for leg, name, nrows in legs:
            sums = column and leg >= 2
            warps = cpo.SUMS_WARPS[nrows] if sums else cpo.LANE_WARPS
            smem = (cpo.lane_sums_smem(129, nrows) if sums
                    else cpo.lane_hist_smem(129, nrows))
            blocks = ctypes.c_int(0)
            rc = fn(leg, 129, warps, ctypes.byref(blocks))
            if rc != 0:
                raise RuntimeError(f"occupancy query of {name} failed: CUDA "
                                   f"error {rc}")
            out[name] = {"smem_bytes": smem, "warps": warps,
                         "blocks_per_sm": blocks.value,
                         "grid_blocks_per_sm": cpo.blocks_per_sm(smem)}
    return out


def sorted_sums_instance(mangled: str):
    """The mangled name of ``sorted_sums_kernel<T, W, L>``
    (``hist_multi_sums.cu``) -> "T/W/leg" (leg K3s or K3ws), or None for
    another function."""
    m = re.search(r"sorted_sums_kernelI(f|13__nv_bfloat16)"
                  r"(f|13__nv_bfloat16|S\w*?_)Li(\d)E", mangled)
    if not m:
        return None
    t, w, leg = m.groups()
    w = t if w.startswith("S") else w
    return f"{_TYPES[t]}/{_TYPES[w]}/{'K3s' if leg == '1' else 'K3ws'}"


def hist_multi_sums_build(_build, cpo) -> dict:
    """K3s's and K3ws's build report (``hist_multi_sums.cu``): registers
    and spills of each instance (ptxas; only when this process built the
    library), and at 16 ladders of 129 edges the shared bytes a block asks
    for (the kernel's layout, which must equal ``sorted_sums_smem``) and
    the blocks an SM holds (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``;
    a tree without the sorted-tile design reports none), and the static
    shared bytes, which must stay within ``SORTED_STATIC_SMEM``."""
    out = {"ptxas": ptxas_report(_build.build_log.get("hist_multi_sums", ""),
                                 sorted_sums_instance)}
    if "hist_multi_sums" not in _build.SOURCES:
        return out
    lib = _build.load("hist_multi_sums")
    occ = lib.sorted_sums_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    occ.restype = ctypes.c_int
    smem = lib.sorted_sums_smem
    smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    static = lib.sorted_sums_static_smem
    static.argtypes = [ctypes.c_int, ctypes.c_void_p]
    static.restype = ctypes.c_int
    for rows, name in ((1, "k3s"), (2, "k3ws")):
        sbytes = ctypes.c_longlong(0)
        rc = static(rows, ctypes.byref(sbytes))
        if rc != 0:
            raise RuntimeError(f"attribute query of {name} failed: CUDA "
                               f"error {rc}")
        if sbytes.value > cpo.SORTED_STATIC_SMEM:
            raise AssertionError(f"{name}: {sbytes.value} static shared "
                                 f"bytes, SORTED_STATIC_SMEM allows "
                                 f"{cpo.SORTED_STATIC_SMEM}")
        blocks = ctypes.c_int(0)
        rc = occ(rows, 129, 16, ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"occupancy query of {name} failed: CUDA "
                               f"error {rc}")
        nbytes = int(smem(rows, 16, 129))
        if nbytes != cpo.sorted_sums_smem(16, 129, rows):
            raise AssertionError(f"{name}: the kernel's layout takes {nbytes} "
                                 f"shared bytes, sorted_sums_smem says "
                                 f"{cpo.sorted_sums_smem(16, 129, rows)}")
        leg = "K3s" if rows == 1 else "K3ws"
        out[name] = {**out["ptxas"].get(f"f32/f32/{leg}", {}),
                     "smem_bytes": nbytes,
                     "static_smem_bytes": sbytes.value,
                     "ladders_a_block": 16,
                     "warps": cpo.SORTED_THREADS // 32,
                     "blocks_per_sm": blocks.value,
                     "tile": cpo.SORTED_TILE}
    return out


def hist_multi_build(_build, cpo) -> dict:
    """K3's and K3w's build report (``hist_multi.cu``): registers and
    spills of each instance (ptxas; only when this process built the
    library), and for the f32 instances at 16 ladders of 129 edges the
    shared bytes a block asks for (the kernel's layout, which must equal
    ``hist_multi_smem``), its warps and the blocks an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; a tree without
    these entries reports the ptxas lines only)."""
    out = {"ptxas": ptxas_report(_build.build_log.get("hist_multi", ""),
                                 hist_multi_instance)}
    lib = _build.load("hist_multi")
    if not hasattr(lib, "hist_multi_blocks_per_sm"):
        return out
    occ = lib.hist_multi_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p]
    occ.restype = ctypes.c_int
    smem = lib.hist_multi_smem
    smem.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    for rows, name, inst in ((0, "k3", "hist_multi_kernel f32/-/16/-"),
                             (1, "k3w", "whist_multi_kernel f32/f32/16/0")):
        warps = cpo.LANE_WARPS if rows == 0 else cpo.hist_multi_layout(
            16, 129, 1)[1]
        nbytes = int(smem(16, 129, warps, rows))
        if nbytes != cpo.hist_multi_smem(16, warps, 129, rows):
            raise AssertionError(f"{name}: the kernel's layout takes {nbytes} "
                                 f"shared bytes, hist_multi_smem says "
                                 f"{cpo.hist_multi_smem(16, warps, 129, rows)}")
        blocks = ctypes.c_int(0)
        rc = occ(rows, 129, warps, ctypes.byref(blocks))
        if rc != 0:
            raise RuntimeError(f"occupancy query of {name} failed: CUDA "
                               f"error {rc}")
        out[name] = {**out["ptxas"].get(inst, {}), "smem_bytes": nbytes,
                     "ladders_a_block": 16, "warps": warps,
                     "blocks_per_sm": blocks.value}
    return out


def row_sums_times(cpo, ref) -> dict:
    """``row_sums`` on the rows batch (64, 2^20) f32 with dense f32 weights,
    in the finalize's mode (w over x <= a per-row value) and as the
    counting mean's sum of x: ms, the plain version's, one
    ``torch.sum(..., dim=1)`` of the same terms (the library call whose
    order follows the batch), and the bytes bound."""
    x = torch.randn((ROWS, N_ROW), generator=gen(131), device=DEVICE)
    wd = dense_weights((ROWS, N_ROW), 132)
    c = x[:, 12345].contiguous()
    out = {}
    for label, mode, lib in (
            ("le", "le", lambda: torch.sum(torch.where(x <= c[:, None], wd,
                                                       0.0), dim=1)),
            ("x", None, lambda: torch.sum(x, dim=1))):
        nbytes = x.numel() * 4 * (1 if mode is None else 2) + ROWS * 8
        out[label] = dict(
            ms=cuda_ms(lambda: row_sums_call(cpo, x, wd, c, mode), reps=20),
            plain_ms=cuda_ms(lambda: row_sums_plain(ref, x, wd, c, mode,
                                                    torch.float32), reps=3),
            library_ms=cuda_ms(lib, reps=20),
            bound=bound(nbytes, x.numel()))
    return out


def lane_build(report: dict, leg: str, instance: str) -> dict:
    """A lane-private leg's registers, spills, shared bytes and blocks
    per SM from ``hist_batched_build``'s report."""
    return {**report["ptxas"].get(instance, {}), **report.get(leg, {})}


def hist_rows_times(cpo, ref, weighted: bool) -> dict:
    """K1 (K1w with ``weighted``, dense weights) through its wrapper on
    randn at (1, 2^27) and (64, 2^20), x f32 and bf16 (and w f32 and bf16
    on K1w), at the first sweep's ladder (each row's [min, max], every
    element inside; ``full_bracket``, as the engine calls it) and at a
    narrow one (-1e-3, 2e-3], 128 bins: ms by "shape/x/w/sweep"."""
    out = {}
    pairs = WDTYPES if weighted else ((torch.float32, None),
                                      (torch.bfloat16, None))
    for shape, (rows, n), seed in (("1x2^27", (1, N_BIG), 8),
                                   ("64x2^20", (ROWS, N_ROW), 9)):
        x = torch.randn((rows, n), generator=gen(seed), device=DEVICE)
        w = dense_weights((rows, n), seed + 300) if weighted else None
        ladders = {"first": ref.bin_edges(x.amin(1), x.amax(1), 128),
                   "narrow": ref.bin_edges(
                       torch.full((rows,), -1e-3, device=DEVICE),
                       torch.full((rows,), 2e-3, device=DEVICE), 128)}
        for xdt, wdt in pairs:
            xx = x.to(xdt)
            ww = None if w is None else w.to(wdt)
            for sweep, e in ladders.items():
                e = e.contiguous()
                key = (f"{shape}/{_KEYS[xdt]}/"
                       f"{'-' if wdt is None else _KEYS[wdt]}/{sweep}")
                fk = full_kw(cpo, sweep == "first")
                if weighted:
                    out[key] = cuda_ms(lambda: cpo.wcp_histogram_batched(
                        xx, ww, e, **fk), reps=20)
                else:
                    out[key] = cuda_ms(lambda: cpo.cp_histogram_batched(
                        xx, e, **fk), reps=20)
            del xx, ww
        del x, w
    return out


_KEYS = {torch.float32: "f32", torch.bfloat16: "bf16"}


def sum_blocks_timing(cpo) -> dict:
    """``sum_blocks`` at K4w's 16 pivots on 2^27 and at K1w's rows batch
    (64, 2^20), against ``torch.sum`` over the block axis, which is both
    its plain version and the library call for the same sums; device time
    from CUDA-graph replays (``graph_ms``)."""
    out = {}
    for label, shape in (("", sum_blocks_shapes(cpo)[1]),
                         ("rows_", sum_blocks_shapes(cpo)[8])):
        part = torch.rand(shape, generator=gen(210), device=DEVICE)
        outer, nblk, inner = part.shape
        out.update({
            f"{label}ms": graph_ms(lambda: cpo._sum_blocks(part)),
            f"{label}plain_ms": graph_ms(lambda: torch.sum(part, dim=1)),
            f"{label}bound": bound(part.numel() * 4 + outer * inner * 4,
                                   outer * inner * (nblk - 1)),
            f"{label}shape": list(part.shape)})
    return out


def rows_path_times(sel, obj) -> dict:
    """The answers of the row histogram's main path end to end, each with
    its sweeps and its stats / loop / finalize breakdown: ``median`` of
    2^27 f32, ``select_rows`` on (64, 2^20) with per-row k,
    ``weighted_median`` of 2^27 with 0/1 weights at density 1/16 and with
    dense weights, ``weighted_select_rows`` on (64, 2^20) with integer
    weights."""
    x = torch.randn(N_BIG, generator=gen(8), device=DEVICE)
    xr = torch.randn((ROWS, N_ROW), generator=gen(9), device=DEVICE)
    ks = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(10),
                       device=DEVICE)
    w01 = (torch.rand(N_BIG, generator=gen(93), device=DEVICE)
           < 1 / 16).float()
    wd = dense_weights(N_BIG, 92)
    wr = torch.randint(0, 8, (ROWS, N_ROW), generator=gen(95),
                       device=DEVICE).float()
    wks = (torch.rand(ROWS, generator=gen(96), device=DEVICE)
           * wr.sum(dim=1)).floor()
    cap, cap_rows = sel._default_cap(N_BIG), sel._default_cap_rows(N_ROW)
    k_med = (N_BIG + 1) // 2
    cases = (
        ("median", lambda: sel.median(x),
         lambda: obj.RowsEvaluator(x[None], k_med), cap),
        ("select_rows", lambda: sel.select_rows(xr, ks),
         lambda: obj.RowsEvaluator(xr, ks), cap_rows),
        ("weighted_median_01", lambda: sel.weighted_median(x, w01),
         lambda: obj.RowsEvaluator(x[None], 0.5 * w01.sum(),
                                   weights=w01[None]), cap),
        ("weighted_median_dense", lambda: sel.weighted_median(x, wd),
         lambda: obj.RowsEvaluator(x[None], 0.5 * wd.sum(),
                                   weights=wd[None]), cap),
        ("weighted_select_rows", lambda: sel.weighted_select_rows(xr, wr, wks),
         lambda: obj.RowsEvaluator(xr, wks, weights=wr), cap_rows))
    out = {}
    for label, call, make, cp in cases:
        out[f"{label}_ms"] = cuda_ms(call, reps=1, rounds=5)
        out[f"{label}_stats_ms"] = cuda_ms(lambda: make().init_stats(),
                                           reps=1, rounds=5)
        ev = make()
        out[f"{label}_loop_ms"] = cuda_ms(lambda: sel.binned_loop_batched(
            ev, nbins=128, cap=cp), reps=1, rounds=5)
        st, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cp)
        w = {"w": ev.w.to(ev.k.dtype)} if ev.weighted else {}
        out[f"{label}_finalize_ms"] = cuda_ms(lambda: sel._finalize_rows(
            ev.x, ev.k, st, cp, xmin, xmax, **w), reps=1, rounds=5)
        out[f"{label}_sweeps"] = int(st.iters.max())
        del ev, st
    return out


def k1w_outputs(cpo, ref) -> dict:
    """K1w's counts and masses on 2 rows of ``N_IDENT`` with the SPECIALS
    (rows long enough for the lane-private design), at two bracket kinds
    and at the first sweep's ladders (``full_bracket``), with integer and
    with dense weights, for ``compare_outputs``."""
    x = special_data(2, N_IDENT, 41)
    weights = {"int": int_weights((2, N_IDENT), 42),
               "dense": dense_weights((2, N_IDENT), 43)}
    out = {}
    for label, e in (("kinds", edge_ladders(ref, bracket_kinds()[:2], 128)),
                     ("first sweep", first_sweep_edges(ref, x, 128))):
        for wl, w in weights.items():
            cnt, mass, _ = cpo.wcp_histogram_batched(
                x, w, e, **full_kw(cpo, label == "first sweep"))
            out[f"k1w {label} {wl}"] = [cnt.tolist(), mass.tolist()]
    return out


def k1_sums_outputs(cpo, ref, sel, obj) -> dict:
    """K1s's and K1ws's counts, sums and masses on 2 rows of ``N_IDENT``
    (rows long enough for the lane-column design) at two bracket kinds and
    on the polished first sweep (``full_bracket``): on integer data (every
    sum exact) and on randn with the SPECIALS and dense weights, for
    ``compare_outputs``."""
    out = {}
    for label, x, w in (("int", int_sparse_data(2, N_IDENT, 48),
                         int_weights((2, N_IDENT), 49)),
                        ("dense", special_data(2, N_IDENT, 50),
                         dense_weights((2, N_IDENT), 51))):
        xc = torch.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        k = torch.full((2,), (N_IDENT + 1) // 2, device=DEVICE)
        for lad, e, full in (
                ("kinds", edge_ladders(ref, bracket_kinds()[:2], 128), False),
                ("polished", rows_polish_edges(sel, obj, xc, k), True)):
            for leg, ww in (("k1s", None), ("k1ws", w)):
                out[f"{leg} {label} {lad}"] = [
                    t.tolist() for t in rows_sums_call(cpo, x, ww, e, full)]
    return out


def k3_sweep_times(sel, cpo, ref) -> dict:
    """K3, K3w, K3s and K3ws through their wrappers at 2^27 f32, K = 16
    (dense f32 w): the first sweep's 16 identical ladders (K3 with the
    main path's ``full_bracket``) and the distinct narrow ones its descent
    step picks (ms)."""
    x = torch.randn(N_BIG, generator=gen(151), device=DEVICE)
    wd = dense_weights(N_BIG, 152)
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e1 = e1.contiguous()
    cum = torch.cumsum(cpo.cp_histogram_multi(x, e1)[0][:, :-1], dim=-1,
                       dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e1, e1[:, 0], e1[:, -1], ks)
    e2 = ref.bin_edges(yl, yr, 128).contiguous()
    out = {}
    for sweep, e in (("first", e1), ("narrow", e2)):
        kw = k3_kw(cpo, sweep == "first")  # the main path's designs
        kww = k3_kw(cpo, sweep == "first", cpo.wcp_histogram_multi)
        for leg, call in (
                ("k3", lambda: cpo.cp_histogram_multi(x, e, **kw)),
                ("k3w", lambda: cpo.wcp_histogram_multi(x, wd, e, **kww)),
                ("k3s", lambda: cpo.cp_histogram_multi(x, e,
                                                       want_sums=True)),
                ("k3ws", lambda: cpo.wcp_histogram_multi(x, wd, e,
                                                         want_sums=True))):
            out[f"{leg}_{sweep}"] = cuda_ms(call, reps=20)
    return out


def k3_sums_outputs(cpo, ref) -> dict:
    """K3s's and K3ws's counts, sums and masses at n = N_ODD on the five
    bracket kinds cycled over 16 ladders: on integer data (every sum
    exact) and on randn with the SPECIALS and dense weights, for
    ``compare_outputs``."""
    kinds = bracket_kinds()
    e = edge_ladders(ref, [kinds[j % 5] for j in range(16)], 128)
    out = {}
    for label, x, w in (("int", int_sparse_data(1, N_ODD, 44)[0],
                         int_weights((N_ODD,), 45)),
                        ("dense", special_data(1, N_ODD, 46)[0],
                         dense_weights(N_ODD, 47))):
        out[f"k3s {label}"] = [t.tolist() for t in cpo.cp_histogram_multi(
            x, e, want_sums=True)]
        out[f"k3ws {label}"] = [t.tolist() for t in cpo.wcp_histogram_multi(
            x, w, e, want_sums=True)]
    return out


def compare_times(sel, cpo, obj, ref, _build) -> dict:
    """What ``--compare`` reads from each tree: the two cp solves
    (``cp_solves``); K2 and K2w at one pivot on 2^27; K4 and K4w at K in
    ``KS_SWEEP`` with x and w each f32 and bf16; whether each of 16 pivots
    alone gets the same bits as among the 16, at 1024 blocks with dense
    weights; fg_multi's build report; ``sum_blocks``'s device time at
    four shapes of its launches; K1 and K1w at the first and narrow
    sweeps (``hist_rows_times``), K1s and K1ws on the polished, uniform
    and narrow ladders (``rows_sums_times``), the row histogram's main
    path end to end (``rows_path_times``) and polished
    (``polish_rows_times``), hist_batched's build report, whether a K1w,
    K1s or K1ws row alone and a K3w ladder alone get the same bits as in
    company, whether a rows-path answer alone equals its entry in the
    batch, hist_multi's build report; and the outputs of K4/K4w, K1w and
    K1s/K1ws for ``compare_outputs``; K3, K3w, K3s and
    K3ws at the first and narrow sweeps (``k3_sweep_times``), K3s and K3ws
    on the polished first sweep, the 16-quantile and 16 weighted-quantile
    paths 'binned' and polished with sweeps, loop and finalize
    (``polish_multi_times``), whether a K3s or K3ws ladder alone gets the
    same bits as among 16 (five ladder sets), hist_multi_sums's build
    report, and K3s's and K3ws's outputs."""
    parts = {str(list(sh)): torch.rand(sh, generator=gen(211), device=DEVICE)
             for sh in (sum_blocks_shapes(cpo)[i] for i in (1, 5, 8, 9))}
    out = {"sum_blocks_device_ms": {k: graph_ms(lambda: cpo._sum_blocks(v))
                                    for k, v in parts.items()},
           "k1_ms": hist_rows_times(cpo, ref, False),
           "k1w_ms": hist_rows_times(cpo, ref, True),
           "k1_sums_ms": rows_sums_times(sel, obj, cpo, ref),
           "polish_rows": polish_rows_times(sel, obj),
           "rows_path": rows_path_times(sel, obj),
           "hist_build": hist_batched_build(_build, cpo),
           "rows_alone_equal_batch": rows_alone_equal_batch(
               cpo, ref, sel, obj, check=False),
           "k3w_ladder_alone_equals_among_16": ladders_alone_equal_among_16(
               cpo, ref, sel, obj, check=False),
           "rows_answers_alone_equal_batch": rows_answers_alone_equal_batch(
               sel, check=False),
           "hist_multi_build": hist_multi_build(_build, cpo),
           "k3_sums_alone_equals_among_16":
               sums_ladders_alone_equal_among_16(cpo, ref, sel, obj,
                                                 check=False),
           "k3_ms": k3_sweep_times(sel, cpo, ref),
           "hist_multi_sums_build": hist_multi_sums_build(_build, cpo)}
    x = torch.randn(N_BIG, generator=gen(151), device=DEVICE)
    wd = dense_weights(N_BIG, 152)
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    wks = torch.tensor(QS16 * float(wd.double().sum()), dtype=torch.float32,
                       device=DEVICE)
    out["k3_ms"].update({k: v["ms"] for k, v in k3_polish_first_times(
        sel, obj, cpo, x, ks, wd, wks, reps=3).items()})
    out["polish_multi"] = polish_multi_times(sel, obj, x, ks)
    del x, wd
    out["cp"] = cp_solves(sel, obj)
    x = torch.randn(N_BIG, generator=gen(32), device=DEVICE)
    wd = dense_weights(N_BIG, 92)
    y0 = torch.zeros(1, device=DEVICE)
    out["k2_ms"] = cuda_ms(lambda: cpo.cp_partials_batched(x[None], y0),
                           reps=20)
    out["k2w_ms"] = cuda_ms(lambda: cpo.wcp_partials_batched(
        x[None], wd[None], y0), reps=20)
    xs = torch.sort(x).values
    for xdt in (torch.float32, torch.bfloat16):
        out[f"k4_{xdt}_ms"] = k_sweep(sel, cpo, xs, x.to(xdt))
    for xdt, wdt in WDTYPES[:3]:
        out[f"k4w_{xdt}_{wdt}_ms"] = k_sweep(sel, cpo, xs, x.to(xdt),
                                             wd.to(wdt))
    del xs, x, wd
    n = (1 << 23) + 3
    xi = special_data(1, n, 26)[0]
    wi = dense_weights(n, 27)
    y = torch.sort(xi).values[
        sel.ranks_from_quantiles(QS16, n).to(DEVICE).long() - 1]
    out["alone_equals_among_16"] = {}
    for key, multi in (("k4", lambda yy: cpo.cp_partials_multi(xi, yy)),
                       ("k4w", lambda yy: cpo.wcp_partials_multi(xi, wi,
                                                                 yy))):
        got = multi(y)
        out["alone_equals_among_16"][key] = all(
            same_bits(a[j:j + 1], b) for j in range(16)
            for a, b in zip(got, multi(y[j:j + 1])))
    del xi, wi
    # K4's and K4w's outputs on data with the SPECIALS, finite and
    # non-finite pivots, every group size and a ragged tail, for
    # compare_outputs
    x = special_data(1, N_ODD, 25)[0]
    wint = torch.randint(0, 8, (N_ODD,), generator=gen(28),
                         device=DEVICE).float()
    wd = dense_weights(N_ODD, 29)
    piv = torch.tensor([0.0, 1e-3, -0.5, 1e-44, 3e38, 1.5, -2.0, 0.7, -0.0,
                        -1e-39, 2.5, -3e38], device=DEVICE)
    out["outputs"] = {}
    for k in (1, 5, 16, 17, 64):
        y = piv[torch.arange(k, device=DEVICE) % piv.numel()].clone()
        y[-1] = x[12345]
        for pset in ("finite", "nonfinite"):
            if pset == "nonfinite":
                y[0] = NONFINITE[k % 3]
            for leg, got in (("k4", cpo.cp_partials_multi(x, y)),
                             ("k4w int", cpo.wcp_partials_multi(x, wint, y)),
                             ("k4w dense", cpo.wcp_partials_multi(x, wd, y))):
                out["outputs"][f"{leg} K={k} {pset}"] = [
                    t.tolist() for t in got]
    out["outputs"].update(k1w_outputs(cpo, ref))
    out["outputs"].update(k1_sums_outputs(cpo, ref, sel, obj))
    out["outputs"].update(k3_sums_outputs(cpo, ref))
    try:
        out["build"] = fg_multi_build(_build)
    except Exception as e:  # a tree whose build this parser does not read
        out["build"] = f"not read: {e!r}"
    return out


# ladder widths (edges) at which --designs times both K3s/K3ws designs
DESIGN_WIDTHS = (129, 1025, 2049, 4097, 8193)


def sums_design_times(cpo, ref) -> dict:
    """K3s and K3ws (dense f32 w) in both designs, the sorted tile and the
    grouped rows, on 2^27 f32 elements against K = 1 and K = 16 distinct
    ladders that each span every element, at each of ``DESIGN_WIDTHS``
    edges: ms per design, with the counts of the two designs checked
    equal."""
    x = torch.randn(N_BIG, generator=gen(171), device=DEVICE)
    wd = dense_weights(N_BIG, 172)
    pad = torch.arange(16, device=DEVICE, dtype=torch.float32) * 1e-3
    out = {}
    for nedges in DESIGN_WIDTHS:
        e16 = ref.bin_edges(x.min() - pad, x.max() + pad,
                            nedges - 1).contiguous()
        for k in (1, 16):
            e = e16[:k].contiguous()
            for leg, w, key in (
                    ("k3s", None, "cp_histogram_multi_sums"),
                    ("k3ws", wd, "wcp_histogram_multi_sums")):
                row, cnts = {}, []
                for design in ("sorted", "grouped"):
                    def call():
                        return cpo._whist_multi(x, w, e, key, True,
                                                design=design)
                    cnts.append(call()[0])
                    row[design] = cuda_ms(call, reps=3, rounds=3,
                                          warmup=1)
                if not torch.equal(*cnts):
                    raise AssertionError(f"{leg} at {nedges} edges, K = {k}:"
                                         f" the designs' counts differ")
                row["layout"] = cpo.hist_multi_sums_layout(
                    nedges, 1 if w is None else 2)
                out[f"{leg} {nedges} edges K={k}"] = row
                log(f"{leg} {nedges} edges K={k}: {row}")
    return out


def compare_outputs(a: dict, b: dict) -> dict:
    """Two trees' ``compare_times`` outputs: whether the counts (and the
    masses and sums on integer data) are equal, and per leg (k4, k4w, k1w,
    k3s, k3ws) how many f32 sums or dense masses carry the same bits and
    the largest relative difference of the others."""
    exact, legs = True, {}
    for case, outs in a.items():
        # K4 (two sums, two counts), K4w (four sums, two counts), K1w
        # (counts, then masses): which outputs are integers
        if case.startswith("k1w "):
            ints = (0,) if "dense" in case else (0, 1)
        elif case.startswith(("k3s ", "k3ws ", "k1s ", "k1ws ")):
            ints = (0,) if "dense" in case else tuple(range(len(outs)))
        else:
            nsums = 2 if case.startswith("k4 ") else 4
            ints = tuple(i for i in range(len(outs))
                         if i >= nsums or ("int" in case and i < 4))
        tally = legs.setdefault(case.split()[0], [0, 0, 0.0])
        for i, (u, v) in enumerate(zip(outs, b[case])):
            u, v = np.array(u), np.array(v)
            if i in ints:
                exact &= bool(np.array_equal(u, v, equal_nan=True))
                continue
            u32, v32 = u.astype(np.float32), v.astype(np.float32)
            bits = (u32.view(np.int32) == v32.view(np.int32)) | (
                np.isnan(u32) & np.isnan(v32))
            tally[0] += int(bits.sum())
            tally[1] += bits.size
            fin = np.isfinite(u) & np.isfinite(v) & ~bits
            if fin.any():
                tally[2] = max(tally[2], float(np.max(
                    np.abs(u[fin] - v[fin]) / np.abs(v[fin]))))
            if (~fin & ~bits).any():  # a non-finite sum that differs
                tally[2] = float("inf")
    return {"counts_and_integer_masses_equal": exact,
            "sums_same_bits": {leg: f"{t[0]}/{t[1]}" for leg, t in
                               legs.items() if t[1]},
            "sums_max_rel_diff": {leg: t[2] for leg, t in legs.items()
                                  if t[1]}}


def _merge(runs):
    """Runs of one tree -> each number as its median and its runs (a key
    missing from a run, such as the registers of a build that run did not
    make, is merged over the runs that have it)."""
    v0 = runs[0]
    if isinstance(v0, dict):
        keys = dict.fromkeys(k for r in runs for k in r)
        return {k: _merge([r[k] for r in runs if k in r]) for k in keys}
    if isinstance(v0, (int, float)) and not isinstance(v0, bool):
        return {"median": statistics.median(runs), "runs": runs}
    return v0 if all(r == v0 for r in runs) else runs


def compare(other: Path, smi: str) -> None:
    """Time this tree against ``other`` (a copy of the repository, e.g. a
    parent commit unpacked with ``git archive``): one process per run, each
    with its tree's package and kernel build, in turns (other, this, this,
    other, ...); prints and writes ``chiprun_out/compare.json``."""
    trees = {"other": other.resolve() / "src", "this": ROOT / "src"}
    for src in trees.values():
        if not (src / "repro_torch").is_dir():
            raise SystemExit(f"no repro_torch package under {src}")
    order = []
    for r in range(COMPARE_ROUNDS):
        order += ["other", "this"] if r % 2 == 0 else ["this", "other"]
    runs = {name: [] for name in trees}
    out = ROOT / "chiprun_out"
    out.mkdir(parents=True, exist_ok=True)
    raw = open(out / "compare_runs.jsonl", "w")
    for name in order:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--times-of", str(trees[name])],
                              capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            log(proc.stdout[-4000:] + proc.stderr[-8000:])
            raise SystemExit(f"the {name} tree's run failed "
                             f"(exit {proc.returncode})")
        runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
        raw.write(json.dumps({"tree": name, **runs[name][-1]}) + "\n")
        raw.flush()
        log(f"{name} run {len(runs[name])}: "
            f"{time.perf_counter() - t0:.1f} s")
    outputs = {k: [r.pop("outputs") for r in v] for k, v in runs.items()}
    for name, outs in outputs.items():
        if any(json.dumps(o) != json.dumps(outs[0]) for o in outs[1:]):
            raise SystemExit(f"the {name} tree's outputs differ from run to "
                             f"run")
    line = json.dumps({"device": torch.cuda.get_device_name(0), "smi": smi,
                       "trees": {k: str(v) for k, v in trees.items()},
                       "order": order,
                       "outputs": compare_outputs(outputs["this"][0],
                                                  outputs["other"][0]),
                       "results": {k: _merge(v) for k, v in runs.items()}})
    raw.close()
    (out / "compare.json").write_text(line + "\n")
    print(line, flush=True)


# the phases of hist_multi.cu's kernels that a build with
# -DHIST_MULTI_PROBE times with clock64 (summed over threads)
PROBE_PHASES = ("load", "buckets", "ends", "slots", "inside", "flush", "-",
                "-")


def hist_multi_instance(mangled: str):
    """The mangled name of a ``hist_multi.cu`` kernel -> "name T/W/G/leg"
    (W "-" and leg "-" on the counting kernel), or None for another
    function."""
    m = re.search(r"\d+(whist_multi_kernel|hist_multi_kernel)"
                  r"I(f|13__nv_bfloat16)(f|13__nv_bfloat16|S\w*?_)?"
                  r"Li(\d+)E(?:Li(\d)E)?E", mangled)
    if not m:
        return None
    name, t, w, g, leg = m.groups()
    w = "-" if w is None else (t if w.startswith("S") else w)
    w = _TYPES.get(w, w)
    return f"{name} {_TYPES[t]}/{w}/{g}/{leg or '-'}"


def probe_build(src: Path, macro: str, _build, instance) -> tuple:
    """Build ``src`` with ``-D<macro>`` into build/probe; returns the
    library's path and its ptxas report (``instance`` names the
    kernels)."""
    out_dir = ROOT / "build" / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"{src.stem}_probe.so"
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, f"-D{macro}",
                          "-o", str(so), str(src)], capture_output=True,
                         text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"probe build failed:\n{res.stdout}{res.stderr}")
    return so, ptxas_report(res.stdout + res.stderr, instance)


def probe_runs(cpo, _build, lib_name: str, so: Path, calls: dict,
               phases) -> dict:
    """Each call's time in the normal build, then its clock64 cycles per
    phase (summed over threads) and their shares through the probe
    library ``so``, which stands in for ``lib_name`` meanwhile."""
    runs = {key: {"ms": cuda_ms(call, reps=20)} for key, call in
            calls.items()}
    lib = ctypes.CDLL(str(so))
    read = getattr(lib, f"{lib_name}_probe_read")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    normal = _build._libs[lib_name]
    _build._libs[lib_name] = lib
    cpo._fns.clear()
    try:
        buf = (ctypes.c_ulonglong * 8)()
        for key, call in calls.items():
            call()
            rc = read(buf, 1)
            if rc != 0:
                raise RuntimeError(f"probe read failed: CUDA error {rc}")
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            probe_s = time.perf_counter() - t0
            rc = read(buf, 1)
            if rc != 0:
                raise RuntimeError(f"probe read failed: CUDA error {rc}")
            cyc = {p: int(buf[i]) for i, p in enumerate(phases) if p != "-"}
            tot = sum(cyc.values()) or 1
            runs[key].update(probe_ms=probe_s * 1e3, cycles=cyc,
                             share={p: c / tot for p, c in cyc.items()})
    finally:
        _build._libs[lib_name] = normal
        cpo._fns.clear()
    return runs


def hist_multi_probe(src: Path, sel, cpo, ref, _build) -> dict:
    """Build ``src`` (a copy of ``hist_multi.cu`` with clock64 phase marks)
    with -DHIST_MULTI_PROBE, run K3 and K3w through it at 2^27 f32, K = 16
    (dense f32 w) on the first sweep's identical ladders and the narrow
    ones its descent step picks, and return each run's clock64 cycles per
    phase summed over threads (and their shares), beside the kernels'
    times in the normal build and the normal build's ptxas report."""
    so, probe_report = probe_build(src, "HIST_MULTI_PROBE", _build,
                                   hist_multi_instance)
    _build.build_all()
    report = ptxas_report(_build.build_log.get("hist_multi", ""),
                          hist_multi_instance)
    x = torch.randn(N_BIG, generator=gen(151), device=DEVICE)
    wd = dense_weights(N_BIG, 152)
    ks = sel.ranks_from_quantiles(QS16, N_BIG).to(DEVICE)
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e1 = e1.contiguous()
    cum = torch.cumsum(cpo.cp_histogram_multi(x, e1)[0][:, :-1], dim=-1,
                       dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e1, e1[:, 0], e1[:, -1], ks)
    e2 = ref.bin_edges(yl, yr, 128).contiguous()
    calls = {}
    for sweep, e in (("first", e1), ("narrow", e2)):
        calls[f"k3_{sweep}"] = (lambda e=e: cpo.cp_histogram_multi(x, e))
        calls[f"k3w_{sweep}"] = (
            lambda e=e: cpo.wcp_histogram_multi(x, wd, e))
    return {"ptxas": report, "probe_ptxas": probe_report,
            "runs": probe_runs(cpo, _build, "hist_multi", so, calls,
                               PROBE_PHASES)}


# the phases of hist_batched.cu's row kernels with sums that a build with
# -DHIST_BATCHED_PROBE times with clock64 (summed over threads): the wait
# for a batch's loads, the end-slot compares and adds, the slot lookup
# (guess or bucket, edge compares, searches), the in-bracket adds, the
# block's flush, and its set-up (staging the edges, zeroing its tables,
# building its buckets)
ROWS_PROBE_PHASES = ("load", "ends", "lookup", "adds", "flush", "setup",
                     "-", "-")


def hist_batched_probe(src: Path, sel, obj, cpo, ref, _build) -> dict:
    """Build ``src`` (``hist_batched.cu`` or a copy with the same phase
    marks) with -DHIST_BATCHED_PROBE and run K1s and K1ws (dense f32 w)
    through it at (1, 2^27) f32 with ``full_bracket`` on the polished and
    the uniform first-sweep ladders (``rows_sums_ladders``): each run's
    clock64 cycles per phase, summed over threads, and their shares,
    beside the kernels' times in the normal build, both builds' ptxas
    reports and ``rows_sums_times``."""
    so, probe_report = probe_build(src, "HIST_BATCHED_PROBE", _build,
                                   hist_batched_instance)
    _build.build_all()
    report = ptxas_report(_build.build_log.get("hist_batched", ""),
                          hist_batched_instance)
    x = torch.randn((1, N_BIG), generator=gen(161), device=DEVICE)
    wd = dense_weights((1, N_BIG), 162)
    calls = {}
    for leg, w in (("k1s", None), ("k1ws", wd)):
        ladders = rows_sums_ladders(sel, obj, ref, x, w)
        for label in ("polished", "uniform"):
            e = ladders[label][0]
            calls[f"{leg}_{label}"] = (
                lambda e=e, w=w: rows_sums_call(cpo, x, w, e, True))
    return {"ptxas": report, "probe_ptxas": probe_report,
            "runs": probe_runs(cpo, _build, "hist_batched", so, calls,
                               ROWS_PROBE_PHASES),
            "times": rows_sums_times(sel, obj, cpo, ref)}


# ---------------------------------------------------------------------------
# Phases 15-17: segmented selection and the robust consumers
# ---------------------------------------------------------------------------

# Two phi3-mini decoder layers' gradients (src/repro/configs/phi3_mini.py:
# d_model 3072, d_ff 8192, 32 heads x 96): per layer the fused qkv and the
# output projection, the gate, up and down projections and two norms, 14
# leaves and 226,504,704 f32 (906 MB) in all
PHI3_LAYER = (("attn", "qkv", (3072, 9216)), ("attn", "o", (3072, 3072)),
              ("mlp", "gate", (3072, 8192)), ("mlp", "up", (3072, 8192)),
              ("mlp", "down", (8192, 3072)), ("ln1", None, (3072,)),
              ("ln2", None, (3072,)))
PHI3_LAYERS = 2
SEG_N, SEG_K = N_BIG, 16            # interleaved segments of one array
SEG_CP_N, SEG_CP_K = N_SMALL, 8     # the auto cp leg
FIT_N, FIT_P = 1 << 20, 8           # lts_fit / lms_fit
LTS_STARTS, LTS_STEPS, LMS_STARTS = 64, 10, 256
IRLS_N, IRLS_ITERS = 1 << 24, 30
KNN_N, KNN_D, KNN_Q, KNN_K = 1 << 20, 16, 256, 32
TS_N, TS_PAIRS = 1 << 20, 1 << 27   # 128 cyclic offsets
# the robust fits run the rows and weighted rows kernels only (and their
# sums legs under polish), with their block and row sums
ROBUST_KERNELS = {"cp_histogram_batched", "cp_partials_batched",
                  "wcp_histogram_batched", "wcp_partials_batched",
                  "cp_histogram_batched_sums", "wcp_histogram_batched_sums",
                  "row_sums", "sum_blocks"}


def phi3_grads(seed: int = 151):
    """Seeded randn gradients of ``PHI3_LAYERS`` phi3-mini decoder layers,
    each leaf at its own scale (1e-4 .. 1) with 16 planted coordinates
    1e3 times its scale (exploding coordinates, the clip's reason)."""
    g = gen(seed)
    layers = []
    for li in range(PHI3_LAYERS):
        layer = {}
        for i, (block, name, shape) in enumerate(PHI3_LAYER):
            scale = 10.0 ** -((li + i) % 5)
            t = torch.randn(shape, generator=g, device=DEVICE) * scale
            flat = t.view(-1)
            pos = torch.randint(0, flat.numel(), (16,), generator=g,
                                device=DEVICE)
            flat[pos] = scale * 1e3 * (torch.rand(16, generator=g,
                                                  device=DEVICE) - 0.5)
            if name is None:
                layer[block] = t
            else:
                layer.setdefault(block, {})[name] = t
        layers.append(layer)
    return {"layers": layers}


def no_launches(cpo, label: str) -> None:
    moved = {k: v for k, v in cpo.LAUNCHES.items() if v}
    if moved:
        raise AssertionError(f"{label}: plain-torch segmented selection "
                             f"launched {moved}")


def segment_oracle(x, seg, ks, nsegs: int) -> torch.Tensor:
    """Each segment's k-th value by sorting: a stable sort by value, then
    a stable sort by segment, indexed at the segment's start + k - 1."""
    xs, vo = torch.sort(x, stable=True)
    so = torch.sort(seg[vo], stable=True).indices
    counts = torch.bincount(seg.long(), minlength=nsegs)
    start = torch.cumsum(counts, 0) - counts
    return xs[so][start + ks.long() - 1]


def check_status(sel, label, res) -> None:
    if bool((res.status == sel.NOT_CONVERGED).any()):
        raise AssertionError(f"{label}: NOT_CONVERGED")


def segmented_path(sel, cpo, rob, tree) -> dict:
    """Phase 15: segmented selection at full size, plain torch on the card
    (no kernel may launch; counts read from zero around each run), each
    value against a sort."""
    out = {}
    # per-leaf thresholds of |g| at q = 0.99 and 0.5, as the per-leaf clip
    # forms them: the leaves concatenated with sorted segment ids
    leaves = rob._tree_flatten(tree)[0]
    sizes = [leaf.numel() for leaf in leaves]
    x = torch.cat([leaf.abs().reshape(-1) for leaf in leaves])
    seg = torch.repeat_interleave(
        torch.arange(len(sizes), dtype=torch.int32, device=DEVICE),
        torch.tensor(sizes, device=DEVICE))
    qs = (0.99, 0.5)
    want = {q: [] for q in qs}
    for leaf, size in zip(leaves, sizes):
        s = torch.sort(leaf.abs().reshape(-1)).values
        for q in qs:
            want[q].append(s[int(np.clip(np.ceil(q * size), 1, size)) - 1])
    want = {q: torch.stack(v) for q, v in want.items()}
    for method in (None, "binned_polish"):
        for q in qs:
            label = f"per-leaf q={q} {method or 'auto'}"
            cpo.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = sel.segmented_quantiles(x, seg, q, sizes, method=method)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            no_launches(cpo, label)
            check_status(sel, label, res)
            if not same_bits(res.value, want[q]):
                raise AssertionError(f"{label}: a threshold differs from "
                                     f"torch.sort of its leaf")
            out[label] = dict(sweeps=sorted(set(res.iters.tolist())),
                              first_call_s=wall)
    del x, seg
    # 2^27 elements in 16 interleaved segments, each its own scale
    g = gen(161)
    segs = torch.randint(0, SEG_K, (SEG_N,), generator=g, device=DEVICE,
                         dtype=torch.int32)
    scale = 10.0 ** torch.linspace(-3, 3, SEG_K, device=DEVICE)
    xs = (torch.randn(SEG_N, generator=g, device=DEVICE)
          * scale[segs.long()] + scale[segs.long()])
    sizes = torch.bincount(segs.long(), minlength=SEG_K)
    ks = ((torch.rand(SEG_K, generator=g, device=DEVICE) * sizes).long()
          + 1).to(torch.int32)
    # a segment alone takes the cap and method that the whole array's size
    # sets, as among the 16
    kw = dict(cap=sel._default_cap_rows(SEG_N),
              method=sel._resolve_method(None, SEG_N))
    cpo.reset_launches()
    a = sel.segmented_order_statistic(xs, segs, ks, nsegs=SEG_K, **kw)
    no_launches(cpo, "segmented 2^27")
    check_status(sel, "segmented 2^27", a)
    if not same_bits(a.value, segment_oracle(xs, segs, ks, SEG_K)):
        raise AssertionError("segmented 2^27: a value differs from the "
                             "per-segment sort")
    b = sel.segmented_order_statistic(xs, segs, ks, nsegs=SEG_K, **kw)
    if not same_results(a, b):
        raise AssertionError("segmented 2^27: two runs differ")
    for i in range(SEG_K):
        xi = xs[segs == i]
        alone = sel.segmented_order_statistic(
            xi, torch.zeros_like(xi, dtype=torch.int32), ks[i:i + 1],
            nsegs=1, **kw)
        if not same_results(alone, [f[i:i + 1] for f in a]):
            raise AssertionError(f"segmented 2^27: segment {i} alone "
                                 f"differs from its entry among {SEG_K}")
    no_launches(cpo, "segmented 2^27 alone")
    out["2^27 x 16 interleaved"] = dict(
        sweeps=sorted(set(a.iters.tolist())),
        status=sorted(set(a.status.tolist())),
        alone_equal_company=True, two_runs_equal=True)
    # the auto cp leg: 50,000 elements in 8 segments
    g = gen(162)
    segc = torch.randint(0, SEG_CP_K, (SEG_CP_N,), generator=g,
                         device=DEVICE, dtype=torch.int32)
    xc = torch.randn(SEG_CP_N, generator=g, device=DEVICE)
    kc = (torch.bincount(segc.long(), minlength=SEG_CP_K) // 3 + 1).to(
        torch.int32)
    cpo.reset_launches()
    c = sel.segmented_order_statistic(xc, segc, kc, nsegs=SEG_CP_K)
    no_launches(cpo, "segmented cp")
    check_status(sel, "segmented cp", c)
    if not same_bits(c.value, segment_oracle(xc, segc, kc, SEG_CP_K)):
        raise AssertionError("segmented cp: a value differs from the sort")
    out["50,000 x 8 cp"] = dict(passes=sorted(set(c.iters.tolist())))
    log("phase 15, segmented selection: " + json.dumps(out))
    return out


def regression(n, p, seed, outlier_frac=0.3, out_scale=500.0):
    """X (n, p) randn with an intercept column, y = X theta + 0.01 noise,
    ``outlier_frac`` of y shifted by out_scale * (1 + U(0, 1)), as
    ``tests/test_robust.py`` makes them."""
    g = gen(seed)
    X = torch.randn((n, p), generator=g, device=DEVICE)
    X[:, -1] = 1.0
    theta = torch.randn(p, generator=g, device=DEVICE)
    y = X @ theta + 0.01 * torch.randn(n, generator=g, device=DEVICE)
    idx = torch.randperm(n, generator=g, device=DEVICE)[:int(outlier_frac
                                                               * n)]
    y[idx] += out_scale * (1 + torch.rand(idx.numel(), generator=g,
                                          device=DEVICE))
    return X, y, theta, idx


def robust_launches(cpo, label, expect) -> dict:
    launches = {k: v for k, v in cpo.LAUNCHES.items() if v}
    if set(launches) - ROBUST_KERNELS:
        raise AssertionError(f"{label}: launched {launches}, beyond the "
                             f"rows kernels")
    for key in expect:
        if not launches.get(key):
            raise AssertionError(f"{label}: {key} never launched")
    # one sum_blocks launch per pass with f32 block partials or row sums
    if launches.get("sum_blocks", 0) != block_sum_passes(cpo.LAUNCHES):
        raise AssertionError(f"{label}: sum_blocks launched "
                             f"{launches.get('sum_blocks', 0)} times")
    return launches


class Swap:
    """Within ``with Swap(rob, name=fn, ...)``, ``robust`` sees a selection
    module whose named functions are replaced (the twins, the recorders)."""

    def __init__(self, rob, **fns):
        self.rob, self.fns = rob, fns

    def __enter__(self):
        self.orig = self.rob.selection
        ns = dict(vars(self.orig))
        ns.update(self.fns)
        self.rob.selection = types.SimpleNamespace(**ns)
        return self

    def __exit__(self, *exc):
        self.rob.selection = self.orig


def recorder(fn, calls: list):
    """``fn`` that appends (args, kwargs, result) of each call to calls."""
    def rec(*args, **kw):
        res = fn(*args, **kw)
        calls.append((args, kw, res))
        return res
    return rec


def timed(fn, spent: list):
    """``fn`` that appends each call's synchronized wall time (ms)."""
    def run(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        torch.cuda.synchronize()
        spent.append((time.perf_counter() - t0) * 1e3)
        return res
    return run


def _result(sel, v):
    v = v.reshape(-1) if v.dim() else v
    zero = torch.zeros_like(v, dtype=torch.int32)
    return sel.SelectResult(value=v, iters=zero, status=zero, y_lo=v,
                            y_hi=v, n_in=zero)


def sort_twins(sel) -> dict:
    """The library way to each selection the fits make (the port never
    calls these): ``torch.sort`` (rows, medians, per-segment), and for
    weighted medians ``torch.sort`` + a gather + ``torch.cumsum`` +
    ``torch.searchsorted``."""
    def select_rows(x, k, **kw):
        ks = torch.as_tensor(k, device=x.device).long().broadcast_to(
            x.shape[:1])
        v = torch.gather(torch.sort(x, dim=1).values, 1, ks[:, None] - 1)
        return _result(sel, v[:, 0])

    def median(x, **kw):
        x = x.reshape(-1)
        return _result(sel, torch.sort(x).values[(x.numel() + 1) // 2 - 1])

    def weighted_median(x, w, **kw):
        xs, order = torch.sort(x.reshape(-1))
        cum = torch.cumsum(w.reshape(-1)[order], 0)
        i = torch.searchsorted(cum, 0.5 * cum[-1:]).clamp(max=xs.numel() - 1)
        return _result(sel, xs[i][0])

    def segmented_quantiles(x, seg, q, sizes, **kw):
        ks = torch.tensor([int(np.clip(np.ceil(q * s), 1, s))
                           for s in sizes], device=x.device)
        return _result(sel, segment_oracle(x, seg, ks, len(sizes)))

    return dict(select_rows=select_rows, median=median,
                weighted_median=weighted_median,
                segmented_quantiles=segmented_quantiles)


def topk_twin(sel):
    """kNN's cutoffs the library way: ``torch.topk`` of the k smallest."""
    def select_rows(x, k, **kw):
        return _result(sel, torch.topk(x, int(k), dim=1,
                                       largest=False).values[:, -1])
    return select_rows


def robust_path(sel, cpo, rob, tree) -> dict:
    """Phase 16: the robust consumers at full size, each value against an
    oracle on the card, counts read from zero around each run; only the
    rows kernels (K1, K1w, K2, K2w, their sums legs under polish) with
    their block and row sums may launch."""
    out = {}
    # LTS: warm and cold give the same bits; the objective is the f64 sum
    # of the h smallest r^2 by sort; the truth is recovered
    X, y, theta, outl = regression(FIT_N, FIT_P, 171)
    h = (FIT_N + FIT_P + 1) // 2
    fits = {}
    for warm in (True, False):
        cpo.reset_launches()
        fits[warm] = rob.lts_fit(172, X, y, n_starts=LTS_STARTS,
                                 c_steps=LTS_STEPS, warm=warm)
        launches = robust_launches(cpo, f"lts_fit warm={warm}",
                                   ("cp_histogram_batched", "row_sums"))
    fw, fc = fits[True], fits[False]
    for name in ("theta", "objective", "inlier_weights"):
        if not same_bits(getattr(fw, name), getattr(fc, name)):
            raise AssertionError(f"lts_fit: warm and cold {name} differ")
    r2 = ((X @ fw.theta - y).double()) ** 2
    best = torch.sort(r2).values[:h].sum()
    if abs(float(fw.objective) - float(best)) > 1e-5 * float(best):
        raise AssertionError(f"lts_fit: objective {float(fw.objective)} "
                             f"against the sorted sum {float(best)}")
    err = float(torch.linalg.norm(fw.theta - theta))
    if err > 1e-2 or float(fw.inlier_weights[outl].sum()) != 0.0:
        raise AssertionError(f"lts_fit: truth not recovered ({err})")
    out["lts_fit"] = dict(
        theta_err=err, objective=float(fw.objective), sorted_sum=float(best),
        warm_sweeps_per_step=fw.sweeps.float().mean(1).tolist(),
        cold_sweeps_per_step=fc.sweeps.float().mean(1).tolist(),
        launches_warm=launches)
    # LMS: the objective is the sorted median of the best start's r^2
    cpo.reset_launches()
    fl = rob.lms_fit(173, X, y, n_starts=LMS_STARTS)
    launches = robust_launches(cpo, "lms_fit", ("cp_histogram_batched",))
    thetas = rob._elemental_thetas(173, X, y, LMS_STARTS)
    R2 = (thetas @ X.T - y[None, :]) ** 2
    med = torch.sort(R2, dim=1).values[:, (FIT_N + 1) // 2 - 1]
    del R2
    bi = int(torch.argmin(med))
    if not (same_bits(fl.objective, med[bi])
            and same_bits(fl.theta, thetas[bi])):
        raise AssertionError("lms_fit: objective differs from the sorted "
                             "median of the best start")
    out["lms_fit"] = dict(objective=float(fl.objective),
                          theta_err=float(torch.linalg.norm(fl.theta
                                                            - theta)),
                          launches=launches)
    del X, y
    # kNN: integer coordinates (d2 exact); each cutoff against the row's
    # sorted k-th value, the predictions against a torch.topk twin
    g = gen(174)
    tx = torch.randint(-8, 9, (KNN_N, KNN_D), generator=g,
                       device=DEVICE).float()
    ty = torch.randint(-4, 5, (KNN_N,), generator=g, device=DEVICE).float()
    cls = torch.randint(0, 10, (KNN_N,), generator=g, device=DEVICE)
    qx = torch.randint(-8, 9, (KNN_Q, KNN_D), generator=g,
                       device=DEVICE).float()
    calls = []
    cpo.reset_launches()
    with Swap(rob, select_rows=recorder(sel.select_rows, calls)):
        pred = rob.knn_predict(tx, ty, qx, KNN_K)
    launches = robust_launches(cpo, "knn_predict", ("cp_histogram_batched",))
    pcls = rob.knn_predict(tx, cls, qx, KNN_K, classify=True, n_classes=10)
    (d2, _), _, res = calls[0]
    check_status(sel, "knn_predict", res)
    kth = torch.sort(d2, dim=1).values[:, KNN_K - 1]
    if not same_bits(res.value, kth):
        raise AssertionError("knn_predict: a cutoff differs from the sorted "
                             "k-th distance")
    ties = int(((d2 == kth[:, None]).sum(1) > 1).sum())
    del d2, calls
    with Swap(rob, select_rows=topk_twin(sel)):
        tpred = rob.knn_predict(tx, ty, qx, KNN_K)
        tcls = rob.knn_predict(tx, cls, qx, KNN_K, classify=True,
                               n_classes=10)
    if not (same_bits(pred, tpred) and torch.equal(pcls, tcls)):
        raise AssertionError("knn_predict: predictions differ from the "
                             "torch.topk twin")
    out["knn_predict"] = dict(launches=launches, rows_with_ties_at_cutoff=ties)
    del tx, ty, cls, qx
    # IRLS at 2^24: warm against cold; each fit's final scale inside the
    # mass interval of its last weighted median's |r| and weights
    X, y, theta, _ = regression(IRLS_N, FIT_P, 175, outlier_frac=0.2,
                                out_scale=50.0)
    for loss in ("huber", "tukey"):
        got = {}
        for warm in (True, False):
            calls = []
            cpo.reset_launches()
            with Swap(rob, weighted_median=recorder(sel.weighted_median,
                                                    calls)):
                got[warm] = rob.irls_fit(X, y, loss=loss, iters=IRLS_ITERS,
                                         warm=warm)
            launches = robust_launches(cpo, f"irls {loss} warm={warm}",
                                       ("wcp_histogram_batched",))
            (r, w), _, res = calls[-1]
            check_status(sel, f"irls {loss}", res)
            check, margins = mass_interval(cpo, r, w)
            check(res)
            if not same_bits(got[warm].scale, torch.clamp(
                    1.4826 * res.value, min=1e-12)):
                raise AssertionError(f"irls {loss}: scale is not its last "
                                     f"weighted median's")
            del calls, r, w
        fw, fc = got[True], got[False]
        out[f"irls_{loss}"] = dict(
            warm_equals_cold={n: same_bits(getattr(fw, n), getattr(fc, n))
                              for n in ("theta", "scale")},
            theta_err=float(torch.linalg.norm(fw.theta - theta)),
            warm_sweeps=fw.sweeps.tolist(), cold_sweeps=fc.sweeps.tolist(),
            margins=margins, launches_warm=launches)
    del X, y
    # Theil-Sen at 2^20 with 2^27 pairs (128 cyclic offsets): the slope
    # inside the mass interval of its weighted median's slopes and
    # weights, the intercept against a sort
    g = gen(176)
    x = torch.randn(TS_N, generator=g, device=DEVICE)
    y = 1.5 * x - 0.5 + 0.05 * torch.randn(TS_N, generator=g, device=DEVICE)
    out_ix = torch.rand(TS_N, generator=g, device=DEVICE) < 0.2
    y = torch.where(out_ix, y + 40.0, y)
    for weighting in ("sen", "uniform"):
        wcalls, mcalls = [], []
        cpo.reset_launches()
        with Swap(rob, weighted_median=recorder(sel.weighted_median, wcalls),
                  median=recorder(sel.median, mcalls)):
            fit = rob.theil_sen_fit(x, y, weighting=weighting,
                                    max_pairs=TS_PAIRS)
        launches = robust_launches(cpo, f"theil_sen {weighting}",
                                   ("wcp_histogram_batched",
                                    "cp_histogram_batched"))
        (s, w), _, sres = wcalls[0]
        check_status(sel, f"theil_sen {weighting}", sres)
        check, margins = mass_interval(cpo, s, w)
        check(sres)
        (r,), _, ires = mcalls[0]
        if not same_bits(fit.intercept, torch.sort(r).values[
                (TS_N + 1) // 2 - 1]):
            raise AssertionError(f"theil_sen {weighting}: intercept differs "
                                 f"from the sorted median")
        out[f"theil_sen_{weighting}"] = dict(
            slope=float(fit.slope), intercept=float(fit.intercept),
            pairs=int(s.numel()), margins=margins,
            sweeps=[int(sres.iters), int(ires.iters)], launches=launches)
        del wcalls, mcalls, s, w, r
    del x, y
    # the clip on the phase-15 pytree: per leaf (thresholds against a sort
    # of each leaf, clipped leaves against torch.clamp), global (its rank
    # against q) and the histogram estimate (within a bin, above)
    q = 0.99
    leaves = rob._tree_flatten(tree)[0]
    cpo.reset_launches()
    clipped, thrs = rob.clip_by_quantile(tree, q, per_leaf=True)
    no_launches(cpo, "clip per leaf")
    for leaf, c, t in zip(leaves, rob._tree_flatten(clipped)[0],
                          rob._tree_flatten(thrs)[0]):
        a = torch.sort(leaf.abs().reshape(-1)).values
        k = int(np.clip(np.ceil(q * a.numel()), 1, a.numel()))
        if not (same_bits(t, torch.clamp(a[k - 1], min=1e-8))
                and torch.equal(c, torch.clamp(leaf, -t, t))):
            raise AssertionError("clip per leaf: a threshold or a clipped "
                                 "leaf differs from its sort")
    del clipped
    cpo.reset_launches()
    clipped, thr = rob.clip_by_quantile(tree, q)
    no_launches(cpo, "clip global")
    flat = torch.cat([leaf.abs().reshape(-1) for leaf in leaves])
    n = flat.numel()
    rank = float(torch.sum(flat <= thr)) / n
    exact = torch.sort(flat).values[int(np.ceil(q * n)) - 1]
    hq = rob.hist_quantile(tree, q)
    lo, hi = float(flat.min().clamp(min=1e-12)), float(flat.max())
    bin_ratio = math.exp((math.log(hi) - math.log(lo)) / 511)
    del flat
    for c, leaf in zip(rob._tree_flatten(clipped)[0], leaves):
        if not torch.equal(c, torch.clamp(leaf, -thr, thr)):
            raise AssertionError("clip global: a clipped leaf differs")
    if abs(rank - q) > 1e-3:
        raise AssertionError(f"clip global: threshold at rank {rank}")
    if not (float(exact) <= float(hq) * (1 + 1e-6)
            and float(hq) <= float(exact) * bin_ratio ** 2):
        raise AssertionError(f"hist_quantile {float(hq)} not within a bin "
                             f"above {float(exact)}")
    out["clip"] = dict(global_threshold=float(thr), exact=float(exact),
                       global_rank=rank, hist_quantile=float(hq),
                       bin_ratio=bin_ratio)
    log("phase 16, robust consumers: " + json.dumps(out))
    return out


def fit_times(sel, rob, name, fit) -> dict:
    """One fit end to end (CUDA events, median of 3 runs) and the ms its
    selections take (each call synchronized, one run), then the same with
    every selection replaced by its sort twin."""
    out = {}
    for label, fns in (("port", {}), ("twin", sort_twins(sel))):
        if name == "knn" and label == "twin":
            fns = dict(select_rows=topk_twin(sel))
        with Swap(rob, **fns):
            ms = cuda_ms(fit, reps=1, rounds=3, warmup=1)
            spent = []
            inner = rob.selection
            wrapped = {k: timed(getattr(inner, k), spent)
                       for k in ("select_rows", "median", "weighted_median",
                                 "segmented_quantiles")}
            with Swap(rob, **wrapped):
                fit()
        out[f"{label}_ms"] = ms
        out[f"{label}_selection_ms"] = sum(spent)
        out[f"{label}_selections"] = len(spent)
    return out


def robust_timings(sel, cpo, ref, rob, tree) -> dict:
    """Phase 17: each fit end to end with its selection ms against its
    sort twin, and the segmented solve's pieces against the bound of one
    read of x and seg."""
    out = {}
    X, y, _, _ = regression(FIT_N, FIT_P, 171)
    out["lts_fit (2^20, 8), 64 starts, 10 steps"] = fit_times(
        sel, rob, "lts", lambda: rob.lts_fit(172, X, y, n_starts=LTS_STARTS,
                                             c_steps=LTS_STEPS))
    out["lms_fit (2^20, 8), 256 starts"] = fit_times(
        sel, rob, "lms", lambda: rob.lms_fit(173, X, y,
                                             n_starts=LMS_STARTS))
    del X, y
    g = gen(174)
    tx = torch.randint(-8, 9, (KNN_N, KNN_D), generator=g,
                       device=DEVICE).float()
    ty = torch.randint(-4, 5, (KNN_N,), generator=g, device=DEVICE).float()
    qx = torch.randint(-8, 9, (KNN_Q, KNN_D), generator=g,
                       device=DEVICE).float()
    out["knn_predict 256 x 2^20, k 32"] = fit_times(
        sel, rob, "knn", lambda: rob.knn_predict(tx, ty, qx, KNN_K))
    del tx, ty, qx
    X, y, _, _ = regression(IRLS_N, FIT_P, 175, outlier_frac=0.2,
                            out_scale=50.0)
    out["irls_fit huber (2^24, 8), 30 iters"] = fit_times(
        sel, rob, "irls", lambda: rob.irls_fit(X, y, iters=IRLS_ITERS))
    del X, y
    g = gen(176)
    x = torch.randn(TS_N, generator=g, device=DEVICE)
    y = 1.5 * x - 0.5 + 0.05 * torch.randn(TS_N, generator=g, device=DEVICE)
    out["theil_sen_fit sen 2^20, 2^27 pairs"] = fit_times(
        sel, rob, "ts", lambda: rob.theil_sen_fit(x, y, max_pairs=TS_PAIRS))
    del x, y
    out["clip_by_quantile per leaf, phi3 x2 (226.5M)"] = fit_times(
        sel, rob, "clip", lambda: rob.clip_by_quantile(tree, 0.99,
                                                       per_leaf=True))
    # the segmented solve's pieces at 2^27 x 16 interleaved segments
    g = gen(161)
    segs = torch.randint(0, SEG_K, (SEG_N,), generator=g, device=DEVICE,
                         dtype=torch.int32)
    xs = torch.randn(SEG_N, generator=g, device=DEVICE)
    ks = (torch.bincount(segs.long(), minlength=SEG_K) // 2 + 1).to(
        torch.int32)
    cap = sel._default_cap_rows(SEG_N)
    seg_t = dict(
        solve_ms=cuda_ms(lambda: sel.segmented_order_statistic(
            xs, segs, ks, nsegs=SEG_K), reps=1, rounds=3, warmup=1),
        sort_twin_ms=cuda_ms(lambda: segment_oracle(xs, segs, ks, SEG_K),
                             reps=1, rounds=3, warmup=1),
        layout_ms=cuda_ms(lambda: sel._segmented_layout(xs, segs, SEG_K),
                          reps=1, rounds=3, warmup=1))
    lx, lseg, plan = sel._segmented_layout(xs, segs, SEG_K)
    counts = torch.bincount(segs.long(), minlength=SEG_K).to(torch.int32)
    ev = sel._segmented_evaluator(lx, lseg, plan, counts, ks)
    xmin, xmax, _ = ev.init_stats()
    e1 = ref.bin_edges(xmin, xmax, 128)
    s, xmn, xmx = sel._run_bracket_phase(ev, "binned", 64, cap, 128)
    seg_t.update(
        stats_ms=cuda_ms(ev.init_stats, reps=1, rounds=3, warmup=1),
        first_sweep_ms=cuda_ms(lambda: ev.histogram(e1), reps=1, rounds=3,
                               warmup=1),
        loop_ms=cuda_ms(lambda: sel._run_bracket_phase(
            ev, "binned", 64, cap, 128), reps=1, rounds=3, warmup=1),
        finalize_ms=cuda_ms(lambda: sel._finalize_segmented(
            lx, lseg, plan, ks, s, cap, xmn, xmx), reps=1, rounds=3,
            warmup=1),
        sweeps=int(s.iters.max()),
        bound_ms=SEG_N * 8 / HBM_BYTES_PER_S * 1e3)
    out["segmented 2^27 x 16"] = seg_t
    return out


# ---------------------------------------------------------------------------
# Phase 18: the distributed layer (4 gloo ranks on the one card, one NCCL)
# ---------------------------------------------------------------------------

DIST_WORLD = 4
DIST_N = N_BIG                      # 2^27 f32 over 4 ranks: 2^25 a rank
DIST_K8_N = 1 << 20                 # the size the reference pins 1 round at
DIST_K8_NBINS, DIST_K8_CAP = 512, 4096
DECILES = np.arange(1, 9) / 10
DIST_TIMEOUT = 900                  # s, per rank process
DIST_REPS = 5
# robust_aggregate's leaves: phi3-mini's attention output projection
# (d_model x d_model, src/repro/configs/phi3_mini.py) and its two RMSNorm
# scales, one replica a rank, replica 3 poisoned at 1e6
AGG_LEAVES = (("o_proj", (3072, 3072)), ("ln1", (3072,)), ("ln2", (3072,)))
# each 1-D and multi-k case: (its wrapper's LAUNCHES key, the leg)
DIST_KERNEL_KEYS = {
    "hist_multi (K3)": ("cp_histogram", "cp_histogram_multi"),
    "whist_multi (K3w)": ("wcp_histogram", "wcp_histogram_multi"),
    "shist_multi_sums (K3s)": ("cp_histogram_sums", "cp_histogram_multi_sums"),
    "wshist_multi_sums (K3ws)": ("wcp_histogram_sums",
                                 "wcp_histogram_multi_sums"),
    "fg_multi (K4)": ("cp_partials", "cp_partials_multi"),
    "wfg_multi (K4w)": ("wcp_partials", "wcp_partials_multi"),
}


def _sync() -> None:
    if torch.cuda.is_available() and DEVICE == "cuda":
        torch.cuda.synchronize()


def _bits_digest(res) -> str:
    """One digest of every field's bytes (the same on every rank)."""
    import hashlib
    h = hashlib.sha256()
    for t in res:
        h.update(t.detach().reshape(-1).cpu().numpy().tobytes())
    return h.hexdigest()


def dist_drive(sel, cpo, label, fn, expect_kernel, record, check=None):
    """Run one distributed call with the launch counts read from zero:
    only ``expect_kernel`` may launch, once per round (``sum_blocks`` with
    it on a leg with f32 partials, ``row_sums`` in a weighted finalize);
    ``check(res)`` raises unless the values are right (rank 0 only)."""
    cpo.reset_launches()
    _sync()
    t0 = time.perf_counter()
    res = fn()
    _sync()
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in cpo.LAUNCHES.items() if v}
    if bool((res.status == sel.NOT_CONVERGED).any()):
        raise AssertionError(f"{label}: NOT_CONVERGED")
    rounds = int(res.iters.max())
    if DEVICE == "cuda":
        block_sums = (launches.get(expect_kernel, 0)
                      if has_block_sums(expect_kernel) else 0) \
            + launches.get("row_sums", 0)
        if (set(launches) - {"sum_blocks", "row_sums"} != {expect_kernel}
                or launches.get("sum_blocks", 0) != block_sums
                or launches[expect_kernel] != rounds):
            raise AssertionError(f"{label}: launched {launches} in {rounds} "
                                 f"rounds, expected {expect_kernel} once a "
                                 f"round (and sum_blocks with f32 partials)")
    if check is not None:
        check(res)
    record[label] = {"value": res.value.reshape(-1).tolist()[:16],
                     "rounds": rounds,
                     "status": sorted(set(res.status.reshape(-1).tolist())),
                     "n_in": res.n_in.reshape(-1).tolist()[:16],
                     "launches": launches, "first_call_ms": wall,
                     "digest": _bits_digest(res)}
    return res


def _equal_to(want, local=None):
    """A check: the value equals ``want`` (a sort oracle) and, where
    given, the local engine's value on the whole array."""
    def check(res):
        got = res.value.float().reshape(-1)
        if not torch.equal(got, want.float().reshape(-1).to(got.device)):
            raise AssertionError(f"value {got.tolist()[:4]} differs from "
                                 f"the oracle {want.reshape(-1).tolist()[:4]}")
        if local is not None and not torch.equal(
                got, local.float().reshape(-1)):
            raise AssertionError("value differs from the local engine's")
    return check


def _timed_ms(fn, reps=DIST_REPS) -> list:
    """Host-clock ms of ``reps`` synchronized calls after one warm-up."""
    fn()
    out = []
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn()
        _sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _breakdown(D, collectives, ops, fn) -> dict:
    """One run of ``fn`` with its local data passes and its collectives
    each synchronized and timed (host clock): the distributed layer's two
    costs; the rest is the seeds, the edges, the finalize's local work."""
    spent = {"local_passes": [], "collectives": []}
    patches = []
    for mod, names, key in (
            (ops, ("fused_histogram", "fused_partials",
                   "fused_weighted_histogram", "fused_weighted_partials",
                   "fused_histogram_multi", "fused_partials_multi",
                   "fused_weighted_histogram_multi",
                   "fused_weighted_partials_multi"), "local_passes"),
            (collectives, ("psum", "pmax", "pmin", "psum_backend",
                           "all_gather"), "collectives"),
            (D, ("psum", "pmax", "pmin", "psum_backend"), "collectives")):
        for name in names:
            orig = getattr(mod, name)
            patches.append((mod, name, orig))
            setattr(mod, name, timed(orig, spent[key]))
    try:
        _sync()
        t0 = time.perf_counter()
        res = fn()
        _sync()
        total = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, orig in patches:
            setattr(mod, name, orig)
    return {"total_ms": total, "rounds": int(res.iters.max()),
            "local_passes_ms": sum(spent["local_passes"]),
            "local_passes": len(spent["local_passes"]),
            "collectives_ms": sum(spent["collectives"]),
            "collectives": len(spent["collectives"])}


def dist_rank_main(rank: int, world: int, init: str, backend: str) -> None:
    """One rank of phase 18: every case of the distributed layer at full
    size, its launches read from zero; rank 0 holds each value against
    ``torch.sort`` of the whole array (or the sort + f64 cumulative-mass
    oracle) and the local engine, and times.  Prints one JSON line last."""
    import datetime

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if DEVICE == "cuda":
        torch.cuda.set_device(0)
    dist.init_process_group(backend, init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.core import collectives
    from repro_torch.core import distributed as D
    from repro_torch.core import robust as rob
    from repro_torch.core import selection as sel
    from repro_torch.kernels import cp_objective as cpo
    from repro_torch.kernels import ops

    mesh = init_device_mesh("cpu" if backend == "gloo" else "cuda",
                            (world,), mesh_dim_names=("data",))
    lead = rank == 0
    rec = {"rank": rank, "world": world, "backend": backend, "cases": {}}
    cases = rec["cases"]
    if backend == "nccl":
        x = torch.randn(DIST_N, generator=gen(181), device=DEVICE)
        xl = x.chunk(world)[rank].contiguous()
        k = (DIST_N + 1) // 2
        xs = torch.sort(x).values if lead else None
        dist_drive(sel, cpo, "sharded_median binned (nccl)",
                   lambda: D.sharded_median(xl, mesh, "data"),
                   "cp_histogram", cases,
                   _equal_to(xs[k - 1]) if lead else None)
        print(json.dumps(rec), flush=True)
        dist.destroy_process_group()
        return

    t_checks = time.perf_counter()

    # ---- robust_aggregate over 4 replicas of phi3-mini leaves -----------
    def replica(r):
        tree = {}
        for i, (name, shape) in enumerate(AGG_LEAVES):
            t = torch.randn(shape, generator=gen(190 + 10 * r + i),
                            device=DEVICE)
            tree[name] = torch.full_like(t, 1e6) if r == 3 else t
        return tree

    mine = replica(rank)
    sorted_reps = {name: torch.sort(torch.stack(
        [replica(r)[name] for r in range(world)]), dim=0).values
        for name, _ in AGG_LEAVES} if lead else None
    agg = {}
    for label, kw in (("mean", {"method": "mean"}),
                      ("median auto (gather)", {"method": "median",
                                                "agg_impl": "auto"}),
                      ("median cp", {"method": "median", "agg_impl": "cp"}),
                      ("median binned", {"method": "median",
                                         "agg_impl": "binned"}),
                      ("trimmed 0.5 (gather)", {"method": "trimmed",
                                                "trim": 0.5})):
        cpo.reset_launches()
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        _sync()
        t0 = time.perf_counter()
        out = rob.robust_aggregate(mine, None, **kw)
        _sync()
        ms = (time.perf_counter() - t0) * 1e3
        moved = {k: v for k, v in cpo.LAUNCHES.items() if v}
        if moved:
            raise AssertionError(f"robust_aggregate {label} launched "
                                 f"{moved}")
        agg[label] = {"ms": ms, "digest": _bits_digest(
            [out[n] for n, _ in AGG_LEAVES])}
        if DEVICE == "cuda":
            agg[label]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if lead:
            for name, _ in AGG_LEAVES:
                s = sorted_reps[name]
                got = out[name]
                if kw["method"] == "median":
                    ok = torch.equal(got, s[(world + 1) // 2 - 1])
                else:
                    # the kept replicas: all (mean), or those between the
                    # 2nd and 3rd smallest, ties with them included
                    keep = (torch.ones_like(s, dtype=torch.bool)
                            if kw["method"] == "mean"
                            else (s >= s[1]) & (s <= s[2]))
                    want = torch.where(keep, s.double(), 0).sum(dim=0) \
                        / keep.sum(dim=0)
                    rel = float(((got.double() - want).abs()
                                 / want.abs().clamp(min=1e-30)).max())
                    agg[label].setdefault("max_rel_err", {})[name] = rel
                    ok = rel <= (1e-6 if kw["method"] == "mean"
                                 else 2.0 ** -22)
                if not ok:
                    raise AssertionError(f"robust_aggregate {label}: {name} "
                                         f"differs from the sort of the "
                                         f"replicas")
    rec["robust_aggregate"] = agg
    # the binned aggregation's (S, nbins + 2) tensors stay in this
    # process's cache: hand them back before the 2^27 arrays
    del mine, sorted_reps, out
    if DEVICE == "cuda":
        torch.cuda.empty_cache()

    x = torch.randn(DIST_N, generator=gen(181), device=DEVICE)
    xl = x.chunk(world)[rank].contiguous()
    k = (DIST_N + 1) // 2
    w01 = (torch.rand(DIST_N, generator=gen(182), device=DEVICE)
           < 1 / 16).float()
    wd = dense_weights(DIST_N, 183)
    w01l, wdl = w01.chunk(world)[rank].contiguous(), \
        wd.chunk(world)[rank].contiguous()
    W01 = float(w01.sum())
    assert W01 < EXACT_TOTAL
    ks16 = sel.ranks_from_quantiles(QS16, DIST_N)
    wks16 = torch.tensor(QS16 * W01, dtype=torch.float32, device=DEVICE)
    if lead:
        xs = torch.sort(x).values
        xsw, cumw = sorted_mass(x, w01)

    # ---- 1-D sharded solves (K = 1 views of K3/K4, their legs) ----------
    def oracle(kq):
        return xs[kq - 1] if lead else None

    cold = None
    for method, key in (("binned", "cp_histogram"),
                        ("binned_polish", "cp_histogram_sums"),
                        ("cp", "cp_partials")):
        res = dist_drive(
            sel, cpo, f"sharded_median {method}",
            lambda m=method: D.sharded_median(xl, mesh, "data", method=m),
            key, cases, _equal_to(oracle(k), sel.median(x).value)
            if lead else None)
        cold = res if method == "binned" else cold
    kq = int(sel.ranks_from_quantiles(0.9, DIST_N))
    dist_drive(sel, cpo, "sharded_quantile 0.9 binned",
               lambda: D.sharded_quantile(xl, 0.9, mesh, "data"),
               "cp_histogram", cases,
               _equal_to(oracle(kq), sel.quantile(x, 0.9).value)
               if lead else None)
    warm = dist_drive(sel, cpo, "sharded_median binned, warm (prior=cold)",
                      lambda: D.sharded_median(xl, mesh, "data", prior=cold),
                      "cp_histogram", cases,
                      _equal_to(oracle(k)) if lead else None)
    if int(warm.iters) != 1 or not same_bits(warm.value, cold.value):
        raise AssertionError(f"warm re-selection took {int(warm.iters)} "
                             f"rounds or moved the value")
    wwant = mass_oracle(xsw, cumw, 0.5 * W01) if lead else None
    for method, key in (("binned", "wcp_histogram"),
                        ("binned_polish", "wcp_histogram_sums"),
                        ("cp", "wcp_partials")):
        dist_drive(
            sel, cpo, f"sharded_weighted_median {method}, 0/1 weights",
            lambda m=method: D.sharded_weighted_median(
                xl, w01l, mesh, "data", method=m), key, cases,
            _equal_to(wwant, sel.weighted_median(x, w01).value)
            if lead else None)
    margins = {}
    if lead:
        in_interval, margins = mass_interval(cpo, x, wd)
        local_dense = sel.weighted_median(x, wd)
        in_interval(local_dense)
        local_margins = dict(margins)
    dense = dist_drive(sel, cpo, "sharded_weighted_median binned, dense "
                       "weights", lambda: D.sharded_weighted_median(
                           xl, wdl, mesh, "data"), "wcp_histogram", cases,
                       in_interval if lead else None)
    if lead:
        cases["sharded_weighted_median binned, dense weights"].update(
            mass_interval=margins, local_engine_mass_interval=local_margins,
            local_engine_value=float(local_dense.value),
            equals_local_engine=same_bits(dense.value.reshape(1),
                                          local_dense.value.reshape(1)))
        del xsw, cumw, local_dense

    # ---- multi-k sharded solves (K3/K4 and their legs at K targets) -----
    want16 = xs[(ks16 - 1).long().to(DEVICE)] if lead else None
    for method, key in (("binned", "cp_histogram_multi"),
                        ("binned_polish", "cp_histogram_multi_sums"),
                        ("cp", "cp_partials_multi")):
        dist_drive(sel, cpo, f"sharded_quantiles K=16 {method}",
                   lambda m=method: D.sharded_quantiles(
                       xl, QS16, mesh, "data", method=m), key, cases,
                   _equal_to(want16, sel.quantiles(x, QS16).value)
                   if lead else None)
    if lead:
        xsw, cumw = sorted_mass(x, w01)
        wwant16 = mass_oracle(xsw, cumw, wks16)
        del xsw, cumw
    for method, key in (("binned", "wcp_histogram_multi"),
                        ("binned_polish", "wcp_histogram_multi_sums"),
                        ("cp", "wcp_partials_multi")):
        dist_drive(sel, cpo, f"sharded weighted quantiles K=16 {method}, "
                   f"0/1 weights",
                   lambda m=method: D.sharded_multi_order_statistic(
                       xl, wks16, mesh, "data", method=m, weights=w01l),
                   key, cases,
                   _equal_to(wwant16, sel.weighted_quantiles(
                       x, w01, QS16).value) if lead else None)
    # the reference pins K = 8 deciles at 1 round with nbins 512 and
    # cap_local 4096 at n = 2^20 (at 2^27 a 512th of the bracket holds
    # far more than 4096 elements)
    x8 = x[:DIST_K8_N]
    x8l = x8.chunk(world)[rank].contiguous()
    w8l = w01[:DIST_K8_N].chunk(world)[rank].contiguous()
    ks8 = sel.ranks_from_quantiles(DECILES, DIST_K8_N)
    W8 = float(w01[:DIST_K8_N].sum())
    wks8 = torch.tensor(DECILES * W8, dtype=torch.float32, device=DEVICE)
    if lead:
        want8 = torch.sort(x8).values[(ks8 - 1).long().to(DEVICE)]
        xsw, cumw = sorted_mass(x8, w01[:DIST_K8_N])
        wwant8 = mass_oracle(xsw, cumw, wks8)
    for label, fn, key, want in (
            ("sharded_quantiles K=8 deciles n=2^20 nbins=512 cap 4096",
             lambda: D.sharded_quantiles(
                 x8l, DECILES, mesh, "data", nbins=DIST_K8_NBINS,
                 cap_local=DIST_K8_CAP), "cp_histogram_multi",
             want8 if lead else None),
            ("sharded weighted deciles K=8 n=2^20 nbins=512 cap 4096",
             lambda: D.sharded_multi_order_statistic(
                 x8l, wks8, mesh, "data", nbins=DIST_K8_NBINS,
                 cap_local=DIST_K8_CAP, weights=w8l),
             "wcp_histogram_multi", wwant8 if lead else None)):
        res = dist_drive(sel, cpo, label, fn, key, cases,
                         _equal_to(want) if lead else None)
        if int(res.iters.max()) != 1:
            raise AssertionError(f"{label}: {int(res.iters.max())} rounds")

    rec["checks_s"] = time.perf_counter() - t_checks

    # ---- timings ---------------------------------------------------------
    tm = {}
    for label, fn in (
            ("sharded_median binned", lambda: D.sharded_median(
                xl, mesh, "data")),
            ("sharded_median binned_polish", lambda: D.sharded_median(
                xl, mesh, "data", method="binned_polish")),
            ("sharded_median cp", lambda: D.sharded_median(
                xl, mesh, "data", method="cp")),
            ("sharded_weighted_median binned, dense weights",
             lambda: D.sharded_weighted_median(xl, wdl, mesh, "data")),
            ("sharded_quantiles K=16 binned", lambda: D.sharded_quantiles(
                xl, QS16, mesh, "data"))):
        tm[label] = {"ms": _timed_ms(fn),
                     "breakdown": _breakdown(D, collectives, ops, fn)}
    # the ladder of binned_polish's first round (every rank computes it)
    e = polish_seed_edges(sel, D.ShardedEvaluator(xl, k, None)).reshape(-1)
    dist.barrier()
    if lead and DEVICE == "cuda":
        # rank 0 alone (the others wait): the local engine on the whole
        # array, and the sums legs at one ladder that binned_polish runs
        tm["local median of 2^27, one rank"] = _timed_ms(
            lambda: sel.median(x))
        sums = {}
        for leg, call in (
                ("K3s", lambda d: cpo._whist_multi(
                    xl, None, e[None], "cp_histogram_sums", True, d)),
                ("K3ws", lambda d: cpo._whist_multi(
                    xl, wdl, e[None], "wcp_histogram_sums", True, d))):
            sums[leg] = {d: cuda_ms(lambda: call(d), 20)
                         for d in ("sorted", "grouped")}
            sums[leg]["layout"] = cpo.hist_multi_sums_layout(
                e.numel(), 1 if leg == "K3s" else 2)
            sums[leg]["bound_ms"] = bound(
                xl.numel() * (4 if leg == "K3s" else 8), 0)[0]
        sums["K3 twin (no sums)"] = cuda_ms(
            lambda: cpo.cp_histogram(xl, e), 20)
        sums["shape"] = f"({xl.numel()},) f32, the polished first-round " \
                        f"ladder of {e.numel()} edges"
        tm["sums legs at K=1"] = sums
    dist.barrier()
    rec["timings"] = tm
    print(json.dumps(rec), flush=True)
    dist.destroy_process_group()


def _dist_spawn(world: int, backend: str, tmp: Path) -> list:
    """Run ``world`` ranks of :func:`dist_rank_main` (their output to
    files, so that no rank blocks on a full pipe); the ranks' records."""
    logs = [(tmp / f"{backend}{r}.out", tmp / f"{backend}{r}.err")
            for r in range(world)]
    procs = []
    try:
        for r, (out, err) in enumerate(logs):
            with open(out, "w") as fo, open(err, "w") as fe:
                procs.append(subprocess.Popen(
                    [sys.executable, str(Path(__file__).resolve()),
                     "--dist-rank", str(r), "--dist-world", str(world),
                     "--dist-init", str(tmp / f"init_{backend}"),
                     "--dist-backend", backend], cwd=ROOT, stdout=fo,
                    stderr=fe))
        for p in procs:
            p.wait(timeout=DIST_TIMEOUT)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"rank {r} (exit {p.returncode}):\n{out.read_text()[-1500:]}"
              f"\n{err.read_text()[-3000:]}"
              for r, (p, (out, err)) in enumerate(zip(procs, logs))
              if p.returncode != 0]
    if failed:
        # every failed rank: the first to fail closes its peers' sockets
        raise AssertionError(f"phase 18 {backend} failed:\n"
                             + "\n".join(failed))
    return [json.loads(out.read_text().strip().splitlines()[-1])
            for out, _ in logs]


def distributed_phase() -> dict:
    """Phase 18: 4 gloo ranks on the one card (the kernels built once
    here, before they start), then one NCCL rank; every rank's fields the
    same bits.  Returns rank 0's record with the others' digests."""
    import gc
    import tempfile

    # this process's cached blocks would be out of the ranks' reach
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = _dist_spawn(DIST_WORLD, "gloo", Path(tmp))
        t_gloo = time.perf_counter() - t0
        nccl = _dist_spawn(1, "nccl", Path(tmp))[0]
    lead = ranks[0]
    for other in ranks[1:]:
        for label, case in lead["cases"].items():
            if other["cases"][label]["digest"] != case["digest"]:
                raise AssertionError(f"phase 18: {label} differs between "
                                     f"rank 0 and rank {other['rank']}")
            if other["cases"][label]["launches"] != case["launches"]:
                raise AssertionError(f"phase 18: {label} launched "
                                     f"differently on rank {other['rank']}")
        for label, a in lead["robust_aggregate"].items():
            if other["robust_aggregate"][label]["digest"] != a["digest"]:
                raise AssertionError(f"phase 18: robust_aggregate {label} "
                                     f"differs between ranks")
    lead["gloo_ranks_s"] = t_gloo
    lead["nccl"] = nccl
    lead["per_rank_timings"] = [r["timings"] for r in ranks]
    return lead


# ---------------------------------------------------------------------------
# phase 19: LM serving (the dense decoder in plain torch; the latency
# percentiles through the rows cp leg: row_sums and sum_blocks, no K2 pass)
# ---------------------------------------------------------------------------

SERVE_ARCHES = ("phi3-mini-3.8b", "gemma2-2b")
SERVE_PARAMS = {"phi3-mini-3.8b": 3_821_079_552, "gemma2-2b": 2_614_222_080}
SERVE_B, SERVE_P, SERVE_G = 4, 16, 16   # repro_torch.launch.serve defaults
CARD_CPU_LAYERS, CARD_CPU_STEPS = 2, 4
CARD_CPU_TOL = 1e-4        # |card - CPU| over the largest |logit|, f32
DECODE_B, DECODE_LEN = 2, 64
DECODE_TOL = 2e-3          # |decode - prefill| <= tol * (1 + |prefill|)
PREFILL_B, PREFILL_LEN = 4, 1536   # two KV chunks of 1024, the 2nd padded
F32_FLOPS = 67e12          # H100 SXM, f32 outside the tensor cores


def served_percentiles(sel, cpo, served) -> dict:
    """The served answer's p50 and p99: each equal to ``torch.sort`` of the
    same latencies, none NOT_CONVERGED; then each answer alone with its
    launch counts read from zero (they add up to the serve call's)."""
    lat = served.latencies
    srt = torch.sort(lat).values
    n = lat.numel()
    ranks = {"p50": (n + 1) // 2, "p99": int(sel.ranks_from_quantiles(0.99, n))}
    calls = {"p50": sel.median, "p99": lambda x: sel.quantile(x, 0.99)}
    out = {}
    for label, res in (("p50", served.p50), ("p99", served.p99)):
        check_status(sel, f"serve {label}", res)
        want = srt[ranks[label] - 1].item()
        if res.value.item() != want:
            raise AssertionError(f"serve {label}: {res.value.item()} != "
                                 f"sorted {want}")
        cpo.reset_launches()
        again = calls[label](lat)
        torch.cuda.synchronize()
        if again.value.item() != want:
            raise AssertionError(f"serve {label} alone: {again.value.item()}")
        out[label] = {"ms": want * 1e3, "rank": ranks[label],
                      "iters": int(res.iters), "status": int(res.status),
                      "launches": {k: v for k, v in cpo.LAUNCHES.items()
                                   if v}}
    return out


SERVE_KERNELS = {"cp_partials_batched", "sum_blocks", "row_sums"}
LONG_P, LONG_G = 1024, 128   # the longer window: a cache of 1152 slots


def serve_and_select(sel, cpo, ref, launch, cfg, params, nbytes) -> dict:
    """The launcher's loop at B = 4, prompt 16, gen 16 on ``params``, its
    launch counts read from zero around the call: only the rows cp leg's
    kernels (``SERVE_KERNELS``), ``row_sums`` once an answer (the counting
    mean), ``sum_blocks`` once an answer and once a cp pass, K2 once a cp
    pass.  The ~29 latencies fit the cap (``cap = min(cap, n)``), so the cp
    loop certifies them with no pass, as the reference's does (iters 0,
    the finalize sorts the bracket): K2 launches 0 times here.  The
    percentiles against ``torch.sort``."""
    cpo.reset_launches()
    t0 = time.perf_counter()
    served = launch.serve(cfg, SERVE_B, SERVE_P, SERVE_G, params=params,
                          device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in cpo.LAUNCHES.items() if v}
    if set(launches) - SERVE_KERNELS:
        raise AssertionError(f"serve: kernels off the rows cp leg launched "
                             f"{launches}")
    passes = int(served.p50.iters) + int(served.p99.iters)
    want = {"row_sums": 2, "sum_blocks": 2 + passes,
            "cp_partials_batched": passes}
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"serve: launched {launches}, want {want} for "
                             f"{passes} cp passes")
    answers = served_percentiles(sel, cpo, served)
    for key, count in launches.items():
        alone = sum(a["launches"].get(key, 0) for a in answers.values())
        if alone != count:
            raise AssertionError(f"serve: {key} {count} launches, {alone} "
                                 f"by the answers alone")
    toks = served.tokens
    if toks.shape != (SERVE_B, SERVE_P + SERVE_G - 1) or bool(
            ((toks < 0) | (toks >= cfg.vocab)).any()):
        raise AssertionError(f"serve: tokens {toks.shape} out of range")
    return {"batch": SERVE_B, "prompt_len": SERVE_P, "gen": SERVE_G,
            "wall_s": wall, "ms_per_token_p50": answers["p50"]["ms"],
            "ms_per_token_p99": answers["p99"]["ms"],
            "steps_timed": served.latencies.numel(),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes (the parameters read once a step)",
            "latencies_ms": [v * 1e3 for v in served.latencies.tolist()],
            "launches": launches, "cp_passes": passes, "answers": answers,
            "first_row_tokens": toks[0].tolist(),
            "kernels_at_this_shape": served_kernels(cpo, ref,
                                                    served.latencies)}


def served_kernels(cpo, ref, lat) -> dict:
    """The percentiles' kernels at the shape the path gives them, one row
    of n times (phase 19: the ~29 served latencies; phase 20: the 3 timed
    step times), against their plain versions:
    ``row_sums`` of the row (the counting mean's sum, as the path launches
    it) and its weighted modes, ``sum_blocks`` of the row's partials
    (``fg_blocks(n)`` blocks, as the path launches it) and of the n
    latencies as n blocks, and K2 at (1, n) at the row's median and mean,
    which the path would launch once the latencies outgrew the cap.  In
    whole units of ``q`` microseconds (``q`` = 1 unless the weighted sums
    would reach 2^24) every sum is exact in f32: the kernels' bits equal
    the plain versions' and the exact sum; on the latencies in seconds
    each sum is within its f32 chain of the f64 sum (``row_sums``: the
    kernel's chain, ``sum_blocks``: nblk + 5 adds), K2's within
    ``SUM_RTOL``."""
    x = lat[None, :].contiguous()
    n = x.shape[1]
    q = 1.0
    while float(torch.round(x * 1e6 / q).double().sum()) * 4 >= EXACT_TOTAL:
        q *= 10
    xi = torch.round(x * 1e6 / q)
    exact = {"us": xi.double().sum(dim=1), "s": x.double().sum(dim=1)}
    # row_sums, the sum of x, as the path launches it
    got = cpo.row_sums(xi)
    plain = ref.row_sums_ref(xi, dtype=torch.float32)
    if not (same_bits(got, plain) and torch.equal(got.double(), exact["us"])):
        raise AssertionError(f"row_sums at (1, {n}): {got.item()} != plain "
                             f"{plain.item()}")
    got = cpo.row_sums(x)
    rs_bits = same_bits(got, ref.row_sums_ref(x, dtype=torch.float32))
    rs_err = abs(got.item() - exact["s"].item()) / exact["s"].item()
    rs_bound = (f32_chain(cpo, n) + 1) * 2.0 ** -24
    if not rs_err <= rs_bound:
        raise AssertionError(f"row_sums at (1, {n}): {rs_err} of the f64 "
                             f"sum > {rs_bound}")
    # its weighted modes at this shape, integer weights 1..4
    wi = (torch.arange(n, device=DEVICE, dtype=torch.float32) % 4 + 1)[None]
    c = xi[:, n // 2].contiguous()
    for mode in ROW_MODES[1:]:
        got = row_sums_call(cpo, xi, wi, c, mode)
        plain = row_sums_plain(ref, xi, wi, c, mode, torch.float32)
        if not same_bits(got, plain):
            raise AssertionError(f"row_sums {mode} at (1, {n}): "
                                 f"{got.item()} != plain {plain.item()}")
    # sum_blocks: the row's partials as the path gives them, then n blocks
    nblk = cpo.fg_blocks(n)
    bounds = torch.linspace(0, n, nblk + 1).round().long().tolist()
    part = torch.stack([xi[:, a:b].sum(dim=1) for a, b in
                        zip(bounds[:-1], bounds[1:])], dim=1)[..., None]
    got = cpo._sum_blocks(part.contiguous()).view(1)
    if not torch.equal(got.double(), exact["us"]):
        raise AssertionError(f"sum_blocks of the row's {nblk} partials: "
                             f"{got.item()} != {exact['us'].item()}")
    got = cpo._sum_blocks(xi.view(1, n, 1)).view(1)
    if not torch.equal(got.double(), exact["us"]):
        raise AssertionError(f"sum_blocks of {n} blocks: {got.item()}")
    got = cpo._sum_blocks(x.view(1, n, 1)).view(1)
    sb_err = abs(got.item() - exact["s"].item()) / exact["s"].item()
    if not sb_err <= (n + 6) * 2.0 ** -24:
        raise AssertionError(f"sum_blocks of {n} blocks: {sb_err} of the "
                             f"f64 sum")
    # K2 at (1, n): counts bit for bit, sums exact on an integer pivot in
    # whole units, within SUM_RTOL else
    k2_rel = 0.0
    for label, data in (("us", xi), ("s", x)):
        srt = torch.sort(data, dim=1).values
        for pivot in (srt[:, (n - 1) // 2], (exact[label] / n).float()):
            y = pivot.contiguous()
            got = cpo.cp_partials_batched(data, y)
            want = ref.cp_partials_batched_ref(data, y)
            for g, w in zip(got[2:], want[2:]):
                if not torch.equal(g, w):
                    raise AssertionError(f"K2 counts at (1, {n}) differ")
            integral = label == "us" and float(y) == round(float(y))
            for g, w in zip(got[:2], want[:2]):
                if integral and not same_bits(g, w):
                    raise AssertionError(f"K2 sums at (1, {n}): {g.item()} "
                                         f"!= plain {w.item()}")
                torch.testing.assert_close(g, w, rtol=SUM_RTOL, atol=0)
                if w.item() != 0:
                    k2_rel = max(k2_rel, abs(g.item() - w.item())
                                 / abs(w.item()))
    torch.cuda.synchronize()
    return {"shape": [1, n], "blocks": nblk, "unit_us": q,
            "row_sums_rel_err_s": rs_err, "row_sums_bound": rs_bound,
            "row_sums_bits_equal_plain_s": rs_bits,
            "sum_blocks_rel_err_s": sb_err, "k2_max_rel_err": k2_rel,
            "exact_in_whole_units": ["row_sums (x, mass, moment, le, lt)",
                                     "sum_blocks", "K2 counts",
                                     "K2 sums at the median"]}


def long_window(sel, launch, cfg, params) -> dict:
    """The launcher's loop over a longer window, for the record (the checks
    use the launcher's defaults): prompt ``LONG_P``, gen ``LONG_G``, so
    every step attends over a cache of ``LONG_P + LONG_G`` slots and
    ~1150 steps are timed; their p50 / p99 by the port's selection, each
    equal to ``torch.sort``, none NOT_CONVERGED."""
    t0 = time.perf_counter()
    served = launch.serve(cfg, SERVE_B, LONG_P, LONG_G, params=params,
                          device=DEVICE)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lat = served.latencies
    n = lat.numel()
    srt = torch.sort(lat).values
    out = {"batch": SERVE_B, "prompt_len": LONG_P, "gen": LONG_G,
           "cache_slots": LONG_P + LONG_G, "steps_timed": n, "wall_s": wall}
    for label, res, rank in (
            ("p50", served.p50, (n + 1) // 2),
            ("p99", served.p99, int(sel.ranks_from_quantiles(0.99, n)))):
        check_status(sel, f"long window {label}", res)
        if res.value.item() != srt[rank - 1].item():
            raise AssertionError(f"long window {label}: "
                                 f"{res.value.item()} != sorted")
        out[f"ms_per_token_{label}"] = res.value.item() * 1e3
        out[f"{label}_rank"] = rank
        out[f"{label}_iters"] = int(res.iters)
    out["max_ms"] = srt[-1].item() * 1e3
    return out


def card_against_cpu(model, transformer, train, plan, cfg, params) -> dict:
    """Full width, ``CARD_CPU_LAYERS`` layers: the same weights on the card
    and through the port on the CPU, ``CARD_CPU_STEPS`` decode steps on the
    same tokens: logits within ``CARD_CPU_TOL`` of the largest |logit|,
    greedy tokens equal wherever the CPU's top-2 margin exceeds twice it.
    The cut shares the full model's embedding, first layers and final
    norm."""
    cfg_n = dataclasses.replace(cfg, n_layers=CARD_CPU_LAYERS)
    sub = transformer.Decoder(params.embed,
                              list(params.layers[:CARD_CPU_LAYERS]),
                              params.final_norm, len(cfg.unit))
    cpu = copy.deepcopy(sub).to("cpu")
    step = train.make_serve_step(cfg_n, plan)
    toks = torch.randint(0, cfg.vocab, (SERVE_B, CARD_CPU_STEPS),
                         generator=torch.Generator().manual_seed(191),
                         dtype=torch.int32)
    caches = [model.init_cache(cfg_n, SERVE_B, CARD_CPU_STEPS, plan,
                               dtype=torch.float32, device=d)
              for d in (DEVICE, "cpu")]
    worst, decided = 0.0, 0
    t0 = time.perf_counter()
    for t in range(CARD_CPU_STEPS):
        tg, lg, caches[0] = step(sub, caches[0], toks[:, t:t + 1].to(DEVICE),
                                 t)
        tc, lc, caches[1] = step(cpu, caches[1], toks[:, t:t + 1], t)
        scale = max(1.0, lc.abs().max().item())
        err = (lg.cpu() - lc).abs().max().item() / scale
        if not err <= CARD_CPU_TOL:
            raise AssertionError(f"card vs CPU step {t}: logits differ by "
                                 f"{err} of the largest |logit|")
        worst = max(worst, err)
        top2 = lc[:, -1].topk(2).values
        sure = (top2[:, 0] - top2[:, 1]) > 2 * CARD_CPU_TOL * scale
        if not torch.equal(tg.cpu()[sure], tc[sure]):
            raise AssertionError(f"card vs CPU step {t}: greedy tokens differ")
        decided += int(sure.sum())
    return {"layers": CARD_CPU_LAYERS, "steps": CARD_CPU_STEPS,
            "batch": SERVE_B, "tol": CARD_CPU_TOL, "max_rel_err": worst,
            "tokens_compared": decided,
            "tokens": CARD_CPU_STEPS * SERVE_B,
            "cpu_threads": torch.get_num_threads(),
            "s": time.perf_counter() - t0}


def decode_against_prefill(model, train, plan, cfg, params) -> dict:
    """Full width and depth: the decode logits of a ``DECODE_LEN``-token
    prompt equal the prefill step's at the same positions, within
    ``DECODE_TOL`` * (1 + |prefill|)."""
    toks = torch.randint(0, cfg.vocab, (DECODE_B, DECODE_LEN),
                         generator=gen(193), device=DEVICE,
                         dtype=torch.int32)
    full = train.make_prefill_step(cfg, plan)(params, {"tokens": toks})
    cache = model.init_cache(cfg, DECODE_B, DECODE_LEN, plan,
                             dtype=torch.float32, device=DEVICE)
    step = train.make_serve_step(cfg, plan)
    worst_abs, worst = 0.0, 0.0
    for t in range(DECODE_LEN):
        _, lg, cache = step(params, cache, toks[:, t:t + 1], t)
        want = full[:, t]
        err = (lg[:, 0] - want).abs()
        rel = (err / (1.0 + want.abs())).max().item()
        if not rel <= DECODE_TOL:
            raise AssertionError(f"decode vs prefill at {t}: {rel} > "
                                 f"{DECODE_TOL}")
        worst = max(worst, rel)
        worst_abs = max(worst_abs, err.max().item())
    return {"batch": DECODE_B, "tokens": DECODE_LEN, "tol": DECODE_TOL,
            "max_abs_err": worst_abs, "max_err_over_1_plus_abs": worst,
            "max_abs_logit": full.abs().max().item()}


def timed_prefill(train, plan, cfg, params, total, nbytes) -> dict:
    """One prefill of ``PREFILL_B`` x ``PREFILL_LEN`` tokens after a warm
    one (host clock around a synchronized call), against its operations
    bound: 2 flops per token and matrix weight, and the causal scores and
    values of every layer (4 * B * H * hd * S(S+1)/2)."""
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_LEN),
                         generator=gen(197), device=DEVICE,
                         dtype=torch.int32)
    step = train.make_prefill_step(cfg, plan)
    logits = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    if logits.shape != (PREFILL_B, PREFILL_LEN, cfg.vocab) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill: logits {logits.shape} not finite")
    del logits
    t0 = time.perf_counter()
    logits = step(params, {"tokens": toks})
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del logits
    matrix = total - (0 if cfg.tie_embeddings else cfg.vocab * cfg.d_model)
    S = PREFILL_LEN
    flops = (2 * PREFILL_B * S * matrix + 4 * PREFILL_B * cfg.n_heads
             * cfg.hd * S * (S + 1) // 2 * cfg.n_layers)
    ops_ms, bytes_ms = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return {"batch": PREFILL_B, "tokens": S, "ms": ms, "flops": flops,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "param_bytes_bound_ms": bytes_ms}


def serving_record(p19: dict, name: str, smi: str) -> None:
    """Log phase 19's numbers and write them to chiprun_out/serve.json."""
    log("LM serving (ms, " + name + ", " + smi + "): " + json.dumps(
        {arch: {"ms_per_token_p50_p99": [r["serve"]["ms_per_token_p50"],
                                         r["serve"]["ms_per_token_p99"]],
                "steps_timed": r["serve"]["steps_timed"],
                "long_window_ms_per_token_p50_p99": [
                    r["long_window"]["ms_per_token_p50"],
                    r["long_window"]["ms_per_token_p99"]],
                "long_window_steps_timed": r["long_window"]["steps_timed"],
                "bound_ms": r["serve"]["bound_ms"],
                "prefill": r.get("prefill"),
                "peak_memory_gib": r["peak_memory_gib"]}
         for arch, r in p19.items()}))
    out = ROOT / "chiprun_out"
    out.mkdir(parents=True, exist_ok=True)
    (out / "serve.json").write_text(json.dumps(
        {"device": name, "smi": smi, "phase_19": p19}) + "\n")


PROFILE_STEPS = 3


def decode_profile(model, train, plan, cfg, params) -> dict:
    """Where a full-width decode step's time goes: ``torch.profiler`` over
    ``PROFILE_STEPS`` serve steps (B = 4, a 32-slot cache, after warm
    steps): the host clock per step, the device time per step (the sum of
    the kernels' durations) and its share of the step, kernel launches per
    step, and the device time of the matmuls (cuBLAS / CUTLASS kernels)."""
    from torch.profiler import ProfilerActivity, profile

    step = train.make_serve_step(cfg, plan)
    cache = model.init_cache(cfg, SERVE_B, SERVE_P + SERVE_G, plan,
                             dtype=torch.float32, device=DEVICE)
    tok = torch.zeros((SERVE_B, 1), dtype=torch.int32, device=DEVICE)
    for t in range(3):
        tok, _, cache = step(params, cache, tok, t)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(3, 3 + PROFILE_STEPS):
            tok, _, cache = step(params, cache, tok, t)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / PROFILE_STEPS
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}  # by the first 80 characters of the kernel's name
    for e in kernels:
        name = e.name[:80]
        by_name[name] = by_name.get(name, 0.0) + e.time_range.elapsed_us()
    device = sum(by_name.values()) / 1e3 / PROFILE_STEPS
    gemm = sum(us for name, us in by_name.items()
               if "gemm" in name.lower()) / 1e3 / PROFILE_STEPS
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"steps": PROFILE_STEPS, "wall_ms_per_step": wall,
            "device_ms_per_step": device,
            "device_busy_share": device / wall if wall else None,
            "kernels_per_step": len(kernels) / PROFILE_STEPS,
            "gemm_ms_per_step": gemm,
            "top_kernels_ms_per_step": {
                name: us / 1e3 / PROFILE_STEPS for name, us in top}}


def lm_serving_phase(sel, cpo, ref) -> dict:
    """Phase 19: serve phi3-mini and gemma2 at full width and depth in f32,
    each model freed before the next (see the module docstring)."""
    from repro_torch import train
    from repro_torch.analysis import param_counts
    from repro_torch.configs import get_config, local_plan
    from repro_torch.launch import serve as launch
    from repro_torch.models import model, transformer

    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls must not run in TF32")
    plan = local_plan()
    record = {}
    for arch in SERVE_ARCHES:
        cfg = get_config(arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(gen(19), cfg, device=DEVICE)
        total = param_counts(params, cfg)[0]
        if total != SERVE_PARAMS[arch]:
            raise AssertionError(f"{arch}: {total} parameters")
        nbytes = sum(p.numel() * p.element_size()
                     for p in params.parameters())
        rec = {"params": total, "param_bytes": nbytes, "dtype": "float32",
               "n_layers": cfg.n_layers}
        rec["serve"] = serve_and_select(sel, cpo, ref, launch, cfg, params,
                                        nbytes)
        rec["long_window"] = long_window(sel, launch, cfg, params)
        if arch == SERVE_ARCHES[0]:
            rec["card_vs_cpu"] = card_against_cpu(model, transformer, train,
                                                  plan, cfg, params)
        rec["decode_vs_prefill"] = decode_against_prefill(model, train, plan,
                                                          cfg, params)
        rec["decode_profile"] = decode_profile(model, train, plan, cfg,
                                               params)
        if arch == SERVE_ARCHES[0]:
            rec["prefill"] = timed_prefill(train, plan, cfg, params, total,
                                           nbytes)
        rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        rec["s"] = time.perf_counter() - t0
        del params
        record[arch] = rec
        s = rec["serve"]
        log(f"  {arch}: {total} params; ms per decoded token p50 "
            f"{s['ms_per_token_p50']:.3f} p99 {s['ms_per_token_p99']:.3f} "
            f"(bound {s['bound_ms']:.3f}; {s['steps_timed']} steps); "
            f"cache of {rec['long_window']['cache_slots']} slots p50 "
            f"{rec['long_window']['ms_per_token_p50']:.3f} p99 "
            f"{rec['long_window']['ms_per_token_p99']:.3f} "
            f"({rec['long_window']['steps_timed']} steps); percentiles' "
            f"launches "
            f"{ {k: a['launches'] for k, a in s['answers'].items()} }; "
            f"kernels at (1, {s['steps_timed']}) "
            f"{json.dumps(s['kernels_at_this_shape'])}; decode vs prefill {rec['decode_vs_prefill']['max_abs_err']:.3g}"
            f"; peak {rec['peak_memory_gib']:.2f} GiB; {rec['s']:.1f} s; "
            f"profile {json.dumps(rec['decode_profile'])}")
    torch.cuda.empty_cache()
    return record


# ---------------------------------------------------------------------------
# phase 20: LM training (plain torch on cuBLAS, f32 without TF32; the
# step-time percentiles through row_sums and sum_blocks, K2 at their shape)
# ---------------------------------------------------------------------------

TRAIN_ARCH, TRAIN_LAYERS = "phi3-mini-3.8b", 16
TRAIN_PARAMS = 2_009_041_920   # 16 of phi3-mini's 32 layers at full width
TRAIN_B, TRAIN_S = 4, 1024     # 4,096 tokens a step
TRAIN_TIMED = 3                # after one warm-up step
TRAIN_LOSS_RTOL = 1e-5
TRAIN_THR_RTOL = 1e-3          # 12 cutting-plane passes over other sums
CUT_LAYERS, CUT_STEPS, CUT_B, CUT_S = 2, 2, 1, 128
CKPT_STEPS, CKPT_STOP = 8, 4
TRAIN_KERNELS = {"row_sums", "sum_blocks", "cp_partials_batched"}


def train_flops(cfg, B: int, S: int) -> int:
    """A train step's operations: 6 flops per token and matrix weight
    (forward and backward; the embedding's gather is no matmul), and the
    causal scores and values of every layer, forward and backward (3 x 4 *
    B * H * hd * S(S+1)/2).  Remat's second forward is not counted: the
    bound is the work the step needs."""
    d, H, E, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    layer = d * H * hd * 2 + d * E * hd * 2 + 3 * d * cfg.d_ff
    matrix = cfg.n_layers * layer + d * cfg.vocab
    attn = 3 * 4 * B * H * hd * S * (S + 1) // 2 * cfg.n_layers
    return 6 * matrix * B * S + attn


def event_ms(fn):
    """(fn(), its ms between CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def train_launches(launches: dict, passes: int, label: str) -> dict:
    """The launches of one logged step, as ``serve_and_select`` holds the
    served ones: only the rows cp leg's kernels (``TRAIN_KERNELS``),
    ``row_sums`` once a percentile (the counting mean), ``sum_blocks`` once
    a percentile and once a cp pass, K2 once a cp pass (``passes``, from
    ``fit``'s record).  The quantile clip launches none of them."""
    if set(launches) - TRAIN_KERNELS:
        raise AssertionError(f"{label}: kernels off the rows cp leg "
                             f"launched {launches}")
    want = {"row_sums": 2, "sum_blocks": 2 + passes,
            "cp_partials_batched": passes}
    if any(launches.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"{label}: launched {launches}, want {want} "
                             f"for {passes} cp passes")
    return launches


def params_against(got, want, lr: float, steps: int, label: str) -> dict:
    """Every parameter within 0.05 lr a step of ``want``'s and all but 2%
    within 1e-4 lr (Adam's m / (sqrt(v) + eps) magnifies gradients near
    eps; tests/test_torch_train.py holds the port to the reference so)."""
    far = total = 0
    worst = 0.0
    want = dict(want.named_parameters())
    for n, p in got.named_parameters():
        d = (p.detach().to(want[n].device) - want[n].detach()).abs()
        worst = max(worst, d.max().item())
        far += int((d > 1e-4 * lr).sum())
        total += d.numel()
    if not (worst <= 0.05 * lr * steps and far <= 0.02 * total):
        raise AssertionError(f"{label}: parameters differ by {worst} "
                             f"({far} of {total} beyond 1e-4 lr)")
    return {"max_abs_diff": worst, "max_abs_diff_over_lr": worst / lr,
            "share_beyond_1e-4_lr": far / total}


def train_step_twice(step_mod, step, state, batch, cfg, plan) -> dict:
    """The same train step twice from one state: the parameters are kept
    on the host and put back before the second run (a step's loss and
    clip threshold depend on nothing else); whether the loss and
    ``clip_thr`` agree bit for bit, and where not, whether two forward
    losses do and which gradient leaves differ between two backward
    passes (the op to name)."""
    named = dict(state.params.named_parameters())
    host = {n: p.detach().to("cpu", copy=True) for n, p in named.items()}

    def put_back():
        with torch.no_grad():
            for n, p in named.items():
                p.copy_(host[n])

    runs = []
    for _ in range(2):
        put_back()
        state, m = step(state, batch)
        runs.append({k: v.detach().clone() for k, v in m.items()})
    out = {k: same_bits(runs[0][k], runs[1][k]) for k in ("loss", "clip_thr")}
    out["values"] = {k: [r[k].item() for r in runs]
                     for k in ("loss", "clip_thr")}
    if not (out["loss"] and out["clip_thr"]):
        put_back()
        dev_batch = step_mod._on_device(batch, DEVICE)
        a = step_mod.loss_and_grads(state.params, dev_batch, cfg, plan)
        b = step_mod.loss_and_grads(state.params, dev_batch, cfg, plan)
        out["forward_loss_equal"] = same_bits(a[0], b[0])
        out["differing_grad_leaves"] = [
            n for n in a[2] if not same_bits(a[2][n], b[2][n])]
        del a, b
    del host
    return out


def lm_training_phase(cpo, ref) -> dict:
    """Phase 20: train phi3-mini's first 16 layers at full width through
    ``fit`` (see the module docstring), its step-time percentiles' kernels
    held against their plain versions at the row ``fit`` gave them
    (``served_kernels``), then the 2-layer cut card against CPU and a
    checkpoint resume on a reduced config."""
    import tempfile

    from repro_torch.analysis import param_counts
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config, local_plan
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import SyntheticPipeline, batch_for_shape
    from repro_torch.models import model
    from repro_torch.optim import AdamW
    from repro_torch.train import TrainState, fit, make_train_step
    from repro_torch.train import step as step_mod

    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("f32 matmuls must not run in TF32")
    plan = local_plan()
    rec = {}
    t_phase = time.perf_counter()

    # ---- 16 layers at full width, B x S tokens a step, through fit ------
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS,
                              remat="full")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(gen(20), cfg, device=DEVICE)
    total = param_counts(params, cfg)[0]
    if total != TRAIN_PARAMS:
        raise AssertionError(f"phase 20: {total} parameters")
    opt = AdamW(master_weights=True)
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step = make_train_step(cfg, plan, opt, clip="quantile", clip_q=0.99,
                           clip_maxit=12)
    shape = ShapeConfig("phase20", TRAIN_S, TRAIN_B, "train")
    pipe = SyntheticPipeline(cfg, shape, seed=20)
    logs = []
    try:
        warm = fit(train_step=step, state=state, pipeline=pipe, steps=1,
                   log_every=10 ** 9, log_fn=logs.append)
        cpo.reset_launches()
        timed = fit(train_step=step, state=warm["state"], pipeline=pipe,
                    steps=1 + TRAIN_TIMED, log_every=1 + TRAIN_TIMED,
                    log_fn=logs.append)
        launches = {k: v for k, v in cpo.LAUNCHES.items() if v}
    finally:
        pipe.close()
    if len(timed["percentiles"]) != 1:
        raise AssertionError(f"phase 20: {timed['percentiles']} logs")
    pct = timed["percentiles"][-1]
    launches = train_launches(launches, pct["passes"], "phase 20 fit")
    state = timed["state"]
    losses = warm["losses"] + timed["losses"]
    metrics = warm["metrics"] + timed["metrics"]
    if not (all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"phase 20: losses {losses}")
    # fit's own percentiles of the timed steps, against a sort; their
    # kernels at this row's shape against the plain versions (with n <=
    # cap the finalize sorts the bracket, so the answers alone would not
    # show a wrong sum)
    ts = torch.tensor(timed["times"], dtype=torch.float32)
    srt = torch.sort(ts).values
    n = ts.numel()
    for key, rank in (("p50", (n + 1) // 2), ("p99", math.ceil(0.99 * n))):
        if pct[key] != srt[rank - 1].item():
            raise AssertionError(f"phase 20: fit's {key} {pct[key]} != "
                                 f"sorted {srt[rank - 1].item()}")
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    bound_s = flops / F32_FLOPS
    tokens = TRAIN_B * TRAIN_S
    rec["fit"] = {
        "arch": TRAIN_ARCH, "n_layers": TRAIN_LAYERS, "params": total,
        "batch": TRAIN_B, "seq": TRAIN_S, "tokens_per_step": tokens,
        "optimizer": "AdamW, master_weights", "clip": "quantile 0.99, 12",
        "remat": cfg.remat, "dtype": "float32",
        "losses": losses, "loss_falls": losses[-1] < losses[0],
        "loss_falls_every_step": all(b < a for a, b in zip(losses,
                                                           losses[1:])),
        "clip_thr": [m["clip_thr"] for m in metrics],
        "warm_step_s": warm["times"][0], "step_s": timed["times"],
        "step_ms_p50": pct["p50"] * 1e3, "step_ms_p99": pct["p99"] * 1e3,
        "tokens_per_s_p50": tokens / pct["p50"],
        "flops": flops, "bound_ms": bound_s * 1e3,
        "bound_by": "operations (f32, 67 TFLOP/s)",
        "bound_tokens_per_s": tokens / bound_s,
        "step_over_bound": pct["p50"] / bound_s,
        "launches_per_log": launches, "cp_passes": pct["passes"],
        "kernels_at_this_shape": served_kernels(cpo, ref, ts.to(DEVICE)),
        "log": logs}

    # ---- the step's parts apart, with CUDA events -----------------------
    batch = step_mod._on_device(batch_for_shape(cfg, shape, seed=20,
                                                step=1 + TRAIN_TIMED), DEVICE)
    (loss, _, grads), grads_ms = event_ms(
        lambda: step_mod.loss_and_grads(params, batch, cfg, plan))
    clip_ms = []
    for _ in range(2):
        # the last run's clipped tree freed first: as in a step, one is held
        clipped = None
        (clipped, extra), ms = event_ms(
            lambda: step_mod.clip_grads(grads, "quantile", 0.99, 12))
        clip_ms.append(ms)
    del grads
    _, opt_ms = event_ms(lambda: opt.update_(clipped, state.opt, params))
    del clipped
    step_ms = pct["p50"] * 1e3
    rec["parts"] = {"grads_ms": grads_ms, "clip_ms": clip_ms[-1],
                    "clip_ms_runs": clip_ms, "optimizer_ms": opt_ms,
                    "grads_share": grads_ms / step_ms,
                    "clip_share": clip_ms[-1] / step_ms,
                    "optimizer_share": opt_ms / step_ms}
    rec["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30

    # ---- the same step twice from one state -----------------------------
    rec["determinism"] = train_step_twice(
        step_mod, step, state, batch_for_shape(cfg, shape, seed=20, step=9),
        cfg, plan)
    del state, params, opt, step, batch, warm, timed
    torch.cuda.empty_cache()

    # ---- the 2-layer cut at full width, card against CPU ----------------
    t0 = time.perf_counter()
    cut = dataclasses.replace(cfg, n_layers=CUT_LAYERS)
    cut_shape = ShapeConfig("cut", CUT_S, CUT_B, "train")
    lr = 3e-4
    cpu = model.init(21, cut, device="cpu")
    sides = {"cuda": copy.deepcopy(cpu).to(DEVICE), "cpu": cpu}
    seen = {}
    for dev, p in sides.items():
        o = AdamW(lr=lr)
        st = TrainState(params=p, opt=o.init(p), step=0)
        fn = make_train_step(cut, plan, o, clip="quantile")
        ms = []
        t1 = time.perf_counter()
        for i in range(CUT_STEPS):
            st, m = fn(st, batch_for_shape(cut, cut_shape, seed=21, step=i))
            ms.append({k: v.item() for k, v in m.items()})
        seen[dev] = (ms, time.perf_counter() - t1)
    worst = {"loss": 0.0, "clip_thr": 0.0}
    for mg, mc in zip(seen["cuda"][0], seen["cpu"][0]):
        for k, tol in (("loss", TRAIN_LOSS_RTOL),
                       ("clip_thr", TRAIN_THR_RTOL)):
            err = abs(mg[k] - mc[k]) / abs(mc[k])
            if not err <= tol:
                raise AssertionError(f"phase 20 card vs CPU: {k} "
                                     f"{mg[k]} vs {mc[k]}")
            worst[k] = max(worst[k], err)
    rec["card_vs_cpu"] = {
        "layers": CUT_LAYERS, "steps": CUT_STEPS, "batch": CUT_B,
        "seq": CUT_S, "lr": lr, "loss_rel_err": worst["loss"],
        "clip_thr_rel_err": worst["clip_thr"],
        "loss_tol": TRAIN_LOSS_RTOL, "clip_thr_tol": TRAIN_THR_RTOL,
        **params_against(sides["cuda"], sides["cpu"], lr, CUT_STEPS,
                         "phase 20 card vs CPU"),
        "card_s": seen["cuda"][1], "cpu_s": seen["cpu"][1],
        "cpu_threads": torch.get_num_threads(),
        "s": time.perf_counter() - t0}
    del sides, cpu
    torch.cuda.empty_cache()

    # ---- a checkpoint resume on the card, reduced config ----------------
    rcfg = get_config(TRAIN_ARCH).reduced()
    rshape = ShapeConfig("resume", 32, 2, "train")

    def run(steps, ckpt, seed):
        p = model.init(seed, rcfg, device=DEVICE)
        o = AdamW(lr=1e-2)
        st = TrainState(params=p, opt=o.init(p), step=0)
        pl = SyntheticPipeline(rcfg, rshape, seed=22)
        try:
            return fit(train_step=make_train_step(rcfg, plan, o,
                                                  clip="quantile"),
                       state=st, pipeline=pl, steps=steps, ckpt=ckpt,
                       ckpt_every=2, log_every=10 ** 9,
                       log_fn=lambda line: None)
        finally:
            pl.close()

    full = run(CKPT_STEPS, None, 22)
    with tempfile.TemporaryDirectory() as tmp:
        first = run(CKPT_STOP, CheckpointManager(tmp), 22)
        second = run(CKPT_STEPS, CheckpointManager(tmp), 23)
        kept = CheckpointManager(tmp).steps()
    resumed = first["losses"] + second["losses"]
    final_equal = all(torch.equal(a, b) for a, b in zip(
        full["state"].params.parameters(),
        second["state"].params.parameters()))
    if resumed != full["losses"] or not final_equal:
        raise AssertionError(f"phase 20 resume: {resumed} != "
                             f"{full['losses']} (weights equal: "
                             f"{final_equal})")
    rec["resume"] = {"steps": CKPT_STEPS, "stopped_after": CKPT_STOP,
                     "losses": full["losses"], "resumed_losses": resumed,
                     "final_weights_equal": final_equal,
                     "checkpoints_kept": kept}
    rec["s"] = time.perf_counter() - t_phase
    return rec


def training_record(p20: dict, name: str, smi: str) -> None:
    """Log phase 20's numbers and write them to chiprun_out/train.json."""
    f, parts = p20["fit"], p20["parts"]
    log("LM training (ms, " + name + ", " + smi + "): " + json.dumps(
        {"step_ms_p50_p99": [f["step_ms_p50"], f["step_ms_p99"]],
         "tokens_per_s": f["tokens_per_s_p50"],
         "bound_ms": f["bound_ms"], "step_over_bound": f["step_over_bound"],
         "grads_ms": parts["grads_ms"], "clip_ms": parts["clip_ms"],
         "optimizer_ms": parts["optimizer_ms"],
         "clip_share": parts["clip_share"],
         "optimizer_share": parts["optimizer_share"],
         "losses": f["losses"], "clip_thr": f["clip_thr"],
         "peak_memory_gib": p20["peak_memory_gib"],
         "launches_per_log": f["launches_per_log"],
         "kernels_at_this_shape": f["kernels_at_this_shape"],
         "determinism": p20["determinism"],
         "card_vs_cpu": p20["card_vs_cpu"], "resume": p20["resume"]}))
    out = ROOT / "chiprun_out"
    out.mkdir(parents=True, exist_ok=True)
    (out / "train.json").write_text(json.dumps(
        {"device": name, "smi": smi, "phase_20": p20}) + "\n")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, metavar="TREE",
                    help="time this tree against the repository copy TREE "
                         "instead of running the checks")
    ap.add_argument("--designs", action="store_true",
                    help="time K3s/K3ws in both designs at widths "
                         "DESIGN_WIDTHS instead of running the checks; "
                         "writes chiprun_out/designs.json")
    ap.add_argument("--probe", type=Path, metavar="CU",
                    help="time the phases of hist_multi.cu's kernels "
                         "(HIST_MULTI_PROBE), or of hist_batched.cu's row "
                         "kernels with sums when CU's name starts with "
                         "hist_batched (HIST_BATCHED_PROBE), with clock64 "
                         "in CU, the source or a copy with the same phase "
                         "marks, instead of running the checks; writes "
                         "chiprun_out/probe.json")
    ap.add_argument("--times-of", type=Path, metavar="SRC",
                    help="print, as one JSON line, what --compare reads, "
                         "with the package under SRC")
    # phase 18 runs this script as its ranks
    ap.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dist-init", help=argparse.SUPPRESS)
    ap.add_argument("--dist-backend", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, str(args.times_of or ROOT / "src"))
    if args.dist_rank is not None:
        dist_rank_main(args.dist_rank, args.dist_world, args.dist_init,
                       args.dist_backend)
        return
    from repro_torch.core import objective as obj
    from repro_torch.core import selection as sel
    from repro_torch.core import stream
    from repro_torch.kernels import _build
    from repro_torch.kernels import cp_objective as cpo
    from repro_torch.kernels import ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    if args.compare:
        compare(args.compare, smi)
        return
    if args.designs:
        _build.build_all()
        line = json.dumps({"device": name, "smi": smi,
                           "build": hist_multi_sums_build(_build, cpo),
                           "designs": sums_design_times(cpo, ref)})
        out = ROOT / "chiprun_out"
        out.mkdir(parents=True, exist_ok=True)
        (out / "designs.json").write_text(line + "\n")
        print(line, flush=True)
        return
    if args.probe:
        probe = (hist_batched_probe(args.probe, sel, obj, cpo, ref, _build)
                 if args.probe.name.startswith("hist_batched")
                 else hist_multi_probe(args.probe, sel, cpo, ref, _build))
        line = json.dumps({"device": name, "smi": smi, **probe})
        out = ROOT / "chiprun_out"
        out.mkdir(parents=True, exist_ok=True)
        (out / "probe.json").write_text(line + "\n")
        print(line, flush=True)
        return
    if args.times_of:
        _build.build_all()
        print(json.dumps(compare_times(sel, cpo, obj, ref, _build)),
              flush=True)
        return
    log(f"device: {name} | {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t_build = _build.build_all()
    log(f"built {', '.join(_build.SOURCES)} in {t_build:.1f} s")
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    t0 = time.perf_counter()
    sb_check = check_sum_blocks(cpo)
    rs_check = check_row_sums(cpo, ref)
    k1_check = check_k1(cpo, ref)
    k2_check = check_k2(cpo, ref)
    k3_check = check_k3(cpo, ref)
    k4_check = check_k4(cpo, ref)
    w_checks = [check_k1w(cpo, ref), check_k2w(cpo, ref),
                check_k3w(cpo, ref, sel, obj), check_k4w(cpo, ref)]
    rows_ident = rows_answers_alone_equal_batch(sel)
    log(f"rows path at (64, 2^20): each row alone and the 64 permuted == "
        f"the batch in every field, bit for bit: {json.dumps(rows_ident)}")
    log(f"kernel checks took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = main_path(sel, cpo)
    multi = multi_k_path(sel, cpo)
    weighted, margins = weighted_path(sel, cpo)
    log(f"main paths took {time.perf_counter() - t0:.1f} s; launches "
        f"rows/scalar {launches}, multi-k {multi}, weighted "
        f"{ {k: v for k, v in weighted.items() if v} }")
    for key, count in (("cp_histogram_batched", launches),
                       ("cp_partials_batched", launches),
                       ("row_sums", launches),
                       ("cp_histogram_multi", multi),
                       ("cp_partials_multi", multi),
                       ("wcp_histogram_batched", weighted),
                       ("wcp_partials_batched", weighted),
                       ("wcp_histogram_multi", weighted),
                       ("wcp_partials_multi", weighted)):
        if count[key] == 0:
            raise AssertionError(f"{key} never launched on its main path")
    # every pass with f32 block partials (K2, K4, their weighted legs, and
    # the histogram legs with rows) sums them with one sum_blocks launch
    paths = (launches, multi, weighted)
    sb_launches = sum(d["sum_blocks"] for d in paths)
    passes = sum(block_sum_passes(d) for d in paths)
    if sb_launches == 0 or sb_launches != passes:
        raise AssertionError(f"sum_blocks launched {sb_launches} times on "
                             f"the main paths for {passes} passes with "
                             f"block partials")

    t0 = time.perf_counter()
    tm = timings(sel, cpo, ref, obj)
    tmm = timings_multi(sel, cpo, ref, obj)
    tw = weighted_timings(sel, cpo, ref, obj)
    tcp = cp_solves(sel, obj)
    tsb = sum_blocks_timing(cpo)
    tk1 = {"k1": hist_rows_times(cpo, ref, False),
           "k1w": hist_rows_times(cpo, ref, True)}
    tk1s = rows_sums_times(sel, obj, cpo, ref)
    hbb = hist_batched_build(_build, cpo)
    hmb = hist_multi_build(_build, cpo)
    trs = row_sums_times(cpo, ref)
    log(f"timings took {time.perf_counter() - t0:.1f} s")
    log("K3/K3w build: " + json.dumps(hmb))
    log("row_sums (ms, " + name + ", " + smi + "): " + json.dumps(trs))
    log("K1/K1w sweeps (ms, " + name + ", " + smi + "): " + json.dumps(tk1))
    log("K1s/K1ws sweeps (ms, " + name + ", " + smi + "): "
        + json.dumps(tk1s))
    log("K1/K1w build: " + json.dumps(hbb))
    log("timings (ms, " + name + ", " + smi + "): " + json.dumps(tm))
    log("multi-k timings (ms, " + name + ", " + smi + "): "
        + json.dumps(tmm))
    log("weighted timings (ms, " + name + ", " + smi + "): "
        + json.dumps(tw))
    log("16-target cp solves (ms, " + name + ", " + smi + "): "
        + json.dumps(tcp))
    log("sum_blocks (ms, " + name + ", " + smi + "): " + json.dumps(tsb))
    fgm = fg_multi_build(_build)
    log(f"K4/K4w build (G = 16, f32): " + json.dumps(fgm))

    t0 = time.perf_counter()
    s_checks = [*check_sums_rows(cpo, ref, sel, obj),
                *check_sums_multi(cpo, ref, sel, obj)]
    log(f"sums-leg checks took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    polished = polish_path(sel, cpo)
    warm = warm_path(sel, cpo, stream)
    tick = warm.pop("_tick")
    log(f"polished and warm paths took {time.perf_counter() - t0:.1f} s; "
        f"polish launches { {k: v for k, v in polished.items() if v} }")
    for key in ("cp_histogram_batched_sums", "cp_histogram_multi_sums",
                "wcp_histogram_batched_sums", "wcp_histogram_multi_sums"):
        if polished[key] == 0:
            raise AssertionError(f"{key} never launched on its main path")
    if polished["sum_blocks"] != block_sum_passes(polished):
        raise AssertionError(f"sum_blocks launched {polished['sum_blocks']} "
                             f"times on the polished paths for "
                             f"{block_sum_passes(polished)} sums passes")
    t0 = time.perf_counter()
    ts = sums_timings(sel, cpo, ref, obj, tick)
    del tick
    hms = hist_multi_sums_build(_build, cpo)
    log(f"polish/warm timings took {time.perf_counter() - t0:.1f} s")
    log("polish and warm timings (ms, " + name + ", " + smi + "): "
        + json.dumps({**ts, **warm}))
    log("K3s/K3ws build: " + json.dumps(hms))

    # phases 15-17: segmented selection and the robust consumers (plain
    # torch on top of the rows kernels; imported here, as a tree timed by
    # --compare may predate them)
    from repro_torch.core import robust as rob
    t_new = time.perf_counter()
    tree = phi3_grads()
    t0 = time.perf_counter()
    p15 = segmented_path(sel, cpo, rob, tree)
    log(f"phase 15 (segmented selection) took "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    p16 = robust_path(sel, cpo, rob, tree)
    log(f"phase 16 (robust consumers) took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tr = robust_timings(sel, cpo, ref, rob, tree)
    del tree
    log(f"phase 17 (robust and segmented timings) took "
        f"{time.perf_counter() - t0:.1f} s")
    log("robust and segmented timings (ms, " + name + ", " + smi + "): "
        + json.dumps(tr))
    log(f"phases 15-17 took {time.perf_counter() - t_new:.1f} s")
    # the whole record of phases 15-17, past the end of the output
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "robust.json").write_text(json.dumps(
        {"device": name, "smi": smi, "phase_15": p15, "phase_16": p16,
         "phase_17": tr}) + "\n")

    # phase 18: the distributed layer, 4 gloo ranks on the one card (the
    # kernels are built above, before the ranks start) and one NCCL rank
    t0 = time.perf_counter()
    p18 = distributed_phase()
    t18 = time.perf_counter() - t0
    for label, case in p18["cases"].items():
        log(f"  {label}: rounds {case['rounds']} status {case['status']} "
            f"launches {case['launches']}")
    for label, case in p18["nccl"]["cases"].items():
        log(f"  {label}: rounds {case['rounds']} launches "
            f"{case['launches']}")
    log("robust_aggregate (ms, " + name + ", " + smi + "): "
        + json.dumps(p18["robust_aggregate"]))
    log("distributed timings (ms, rank 0, " + name + ", " + smi + "): "
        + json.dumps(p18["timings"]))
    log(f"phase 18 (distributed, 4 gloo ranks + 1 nccl rank) took "
        f"{t18:.1f} s")
    (out_dir / "distributed.json").write_text(json.dumps(
        {"device": name, "smi": smi, "phase_18_s": t18, "phase_18": p18})
        + "\n")
    # phase 19: LM serving at full width (plain torch; the latency
    # percentiles through row_sums and sum_blocks, K2 at their shape)
    t0 = time.perf_counter()
    p19 = lm_serving_phase(sel, cpo, ref)
    log(f"phase 19 (LM serving) took {time.perf_counter() - t0:.1f} s")
    serving_record(p19, name, smi)
    served = p19[SERVE_ARCHES[0]]["serve"]["answers"]
    served_shape = p19[SERVE_ARCHES[0]]["serve"]["kernels_at_this_shape"]
    # phase 20: LM training at full width (plain torch; the step-time
    # percentiles through row_sums and sum_blocks)
    t0 = time.perf_counter()
    p20 = lm_training_phase(cpo, ref)
    log(f"phase 20 (LM training) took {time.perf_counter() - t0:.1f} s")
    training_record(p20, name, smi)
    train_log = p20["fit"]["launches_per_log"]
    train_shape = p20["fit"]["kernels_at_this_shape"]

    def per_served_answer(key):
        return {k: a["launches"].get(key, 0) for k, a in served.items()}

    dist_launches = {}
    for row, keys in DIST_KERNEL_KEYS.items():
        per_case = {label: sum(case["launches"].get(key, 0) for key in keys)
                    for label, case in p18["cases"].items()}
        dist_launches[row] = {k: v for k, v in per_case.items() if v}

    kernels = [
        {"name": "hist_batched (K1)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hist_batched.cu",
         "replaces": "src/repro/kernels/cp_objective.py:217",
         "launches": launches["cp_histogram_batched"],
         "max_abs_err": k1_check["max_abs_err"],
         "ms": tm["k1"]["ms"], "plain_ms": tm["k1"]["plain_ms"],
         "bound_ms": tm["k1"]["bound"][0], "bound_by": tm["k1"]["bound"][1],
         "library_ms": None,
         "shape": "(1, 2^27) f32, 128 bins, first-sweep edges",
         "design": "first sweep (full_bracket): lane-private 16-bit "
                   "counts, x read in 16-byte packs, slots guessed from the "
                   "ladder's ends and decided by the realized edges, 8 "
                   "elements binned while 8 load; other sweeps: the earlier "
                   "shared histogram",
         "first_sweep_design": "lane",
         "narrow_sweep_design": "shared",
         "first_sweep_ms": tm["k1"]["ms"],
         "narrow_sweep_ms": tm["k1"]["narrow_ms"],
         "narrow_bracket_ms": tm["k1"]["narrow_ms"],
         "rows_64x2^20_ms": tm["k1_rows_ms"],
         "sweeps_ms": tk1["k1"],
         **lane_build(hbb, "k1", "lane_count_kernel f32/f32/-"),
         "nearest_library": "torch.histc, 128 uniform bins",
         "nearest_library_ms": tm["k1"]["histc_ms"]},
        {"name": "fg_batched (K2)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fg_batched.cu",
         "replaces": "src/repro/kernels/cp_objective.py:179",
         "launches": launches["cp_partials_batched"],
         "max_abs_err": k2_check["max_abs_err"],
         "max_rel_err": k2_check["max_rel_err"],
         "ms": tm["k2"]["ms"], "plain_ms": tm["k2"]["plain_ms"],
         "bound_ms": tm["k2"]["bound"][0], "bound_by": tm["k2"]["bound"][1],
         "library_ms": None,
         "shape": "(1, 2^27) f32, one pivot",
         "rows_64x2^20_ms": tm["k2_rows_ms"],
         # phase 19: the served phi3-mini's per-token latency percentiles
         "launches_per_served_answer": per_served_answer(
             "cp_partials_batched"),
         "served_shape_max_rel_err": served_shape["k2_max_rel_err"],
         # phase 20: the step-time percentiles of fit's logged step
         "launches_per_train_log": train_log.get("cp_partials_batched", 0),
         "train_shape_max_rel_err": train_shape["k2_max_rel_err"]},
        {"name": "hist_multi (K3)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hist_multi.cu",
         "replaces": "src/repro/kernels/cp_objective.py:197",
         "launches": multi["cp_histogram_multi"],
         "max_abs_err": k3_check["max_abs_err"],
         "ms": tmm["k3_first"]["ms"], "plain_ms": tmm["k3_first"]["plain_ms"],
         "bound_ms": tmm["k3_first"]["bound"][0],
         "bound_by": tmm["k3_first"]["bound"][1],
         "library_ms": None,
         "shape": "(2^27,) f32, K=16 identical first-sweep ladders, 128 bins",
         "design": "first sweep of identical ladders (full_bracket): K1's "
                   "lane_count_kernel (hist_batched.cu) on the one ladder; "
                   "else the block's distinct bracket ends sorted once, an "
                   "element's bucket by a branch-free search over them "
                   "(lane-private 16-bit bucket counters give every "
                   "ladder's end slots), in-bracket slots guessed and "
                   "decided by the realized edges, integer atomics",
         "first_sweep_design": "hist_batched.cu lane_count_kernel",
         "first_sweep_general_kernel_ms": tmm["k3_first"][
             "general_kernel_ms"],
         **hmb.get("k3", {}),
         "narrow_sweep_ms": tmm["k3_narrow"]["ms"],
         "narrow_sweep_plain_ms": tmm["k3_narrow"]["plain_ms"],
         "narrow_sweep_bound_ms": tmm["k3_narrow"]["bound"][0],
         "narrow_sweep_bound_by": tmm["k3_narrow"]["bound"][1],
         "narrow_sweep_distinct_ladders":
             tmm["k3_narrow"]["distinct_ladders"],
         "nearest_library": "none: no PyTorch call bins one array against "
                            "K given ladders (per ladder, torch.searchsorted "
                            "+ torch.bincount is the plain version)"},
        {"name": "fg_multi (K4)", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fg_multi.cu",
         "replaces": "src/repro/kernels/cp_objective.py:155",
         "launches": multi["cp_partials_multi"],
         "max_abs_err": k4_check["max_abs_err"],
         "max_rel_err": k4_check["max_rel_err"],
         "ms": tmm["k4"]["ms"], "plain_ms": tmm["k4"]["plain_ms"],
         "bound_ms": tmm["k4"]["bound"][0], "bound_by": tmm["k4"]["bound"][1],
         "library_ms": None,
         "shape": "(2^27,) f32, K=16 pivots",
         **fgm["k4"],
         "k_sweep_ms": tmm["k4_sweep_ms"],
         "design": "each (element, pivot) term a predicated add behind "
                   "compares that give a predicate and its complement, "
                   "counts in f32; the next 8 elements loaded while 8 are "
                   "summed; two blocks of 8 warps per SM",
         "nearest_library": "none: no PyTorch call returns the partials of "
                            "K pivots from one read of the array"},
    ]
    weighted_rows = (
        ("whist_batched (K1w)", "hist_batched.cu", 217,
         "wcp_histogram_batched", "k1w",
         "(1, 2^27) f32 x and dense f32 w, 128 bins, first-sweep edges",
         "none: no call bins with weights against given edges"),
        ("wfg_batched (K2w)", "fg_batched.cu", 179, "wcp_partials_batched",
         "k2w", "(1, 2^27) f32 x and dense f32 w, one pivot",
         "none: no call returns these six partials"),
        ("whist_multi (K3w)", "hist_multi.cu", 197, "wcp_histogram_multi",
         "k3w_first", "(2^27,) f32 x and dense f32 w, K=16 identical "
         "first-sweep ladders, 128 bins",
         "none: no call bins with weights against K given ladders"),
        ("wfg_multi (K4w)", "fg_multi.cu", 155, "wcp_partials_multi", "k4w",
         "(2^27,) f32 x and dense f32 w, K=16 pivots",
         "none: no call returns the six partials of K pivots"))
    for (kname, src, line, key, tkey, shape, lib), chk in zip(
            weighted_rows, w_checks):
        row = {"name": kname, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": f"src/repro/kernels/cp_objective.py:{line}",
               "launches": weighted[key], **chk,
               "ms": tw[tkey]["ms"], "plain_ms": tw[tkey]["plain_ms"],
               "bound_ms": tw[tkey]["bound"][0],
               "bound_by": tw[tkey]["bound"][1], "library_ms": None,
               "shape": shape, "nearest_library": lib}
        if key == "wcp_partials_multi":
            row.update(**fgm["k4w"],
                       k_sweep_ms=tw["k4w_sweep_ms"],
                       design="one product w*d per (element, pivot), each "
                              "sum a predicated add, the two counts packed "
                              "in one int; the next 8 elements and weights "
                              "loaded while 8 are summed; two blocks of 8 "
                              "warps per SM")
        if key == "wcp_histogram_batched":
            row.update(design="first sweep (full_bracket) of rows of at "
                              "least LANE_ROWS_MIN_N: lane-private f32 "
                              "masses and 16-bit counts, summed per slot "
                              "over columns, then warps in order; 16 "
                              "elements and weights binned while 16 load; "
                              "other sweeps and shorter rows: the earlier "
                              "grouped rows",
                       first_sweep_design="lane",
                       narrow_sweep_design="grouped",
                       first_sweep_ms=tw["k1w"]["ms"],
                       narrow_sweep_ms=tw["k1w"]["narrow_ms"],
                       narrow_bracket_ms=tw["k1w"]["narrow_ms"],
                       sweeps_ms=tk1["k1w"],
                       **lane_build(hbb, "k1w", "lane_rows_kernel f32/f32/1"))
        if key == "wcp_histogram_multi":
            row.update(design="end slots in per-thread registers (two "
                              "compares, two predicated adds per element and "
                              "distinct ladder), counts from lane-private "
                              "bucket counters over the block's sorted "
                              "bracket ends, in-bracket steps in rounds that "
                              "take a ladder whole (its lanes grouped by "
                              "slot, summed in lane order), slots guessed "
                              "and decided by the realized edges; warps from "
                              "the width alone",
                       **hmb.get("k3w", {}),
                       narrow_sweep_ms=tw["k3w_narrow"]["ms"],
                       narrow_sweep_plain_ms=tw["k3w_narrow"]["plain_ms"],
                       narrow_sweep_bound_ms=tw["k3w_narrow"]["bound"][0],
                       narrow_sweep_distinct_ladders=tw["k3w_narrow"][
                           "distinct_ladders"])
        kernels.append(row)
    sums_rows = (
        ("shist_batched (K1s)", "hist_batched.cu", 217,
         "cp_histogram_batched_sums", "k1s",
         "(1, 2^27) f32, 128 bins, first-sweep edges, counts and sums of x"),
        ("wshist_batched (K1ws)", "hist_batched.cu", 217,
         "wcp_histogram_batched_sums", "k1ws",
         "(1, 2^27) f32 x and dense f32 w, 128 bins, first-sweep edges, "
         "counts, masses and sums of w*x"),
        ("shist_multi_sums (K3s)", "hist_multi_sums.cu", 197,
         "cp_histogram_multi_sums", "k3s_first",
         "(2^27,) f32, K=16 identical first-sweep ladders, 128 bins, counts "
         "and sums of x"),
        ("wshist_multi_sums (K3ws)", "hist_multi_sums.cu", 197,
         "wcp_histogram_multi_sums", "k3ws_first",
         "(2^27,) f32 x and dense f32 w, K=16 identical first-sweep ladders, "
         "128 bins, counts, masses and sums of w*x"))
    for (kname, src, line, key, tkey, shape), chk in zip(sums_rows,
                                                         s_checks):
        t = ts[tkey]
        row = {"name": kname, "route": "cuda",
               "source": f"src/repro_torch/kernels/csrc/{src}",
               "replaces": f"src/repro/kernels/cp_objective.py:{line}",
               "replaces_leg": "src/repro/kernels/cp_objective.py:136 "
                               "(_bin_tile, want_sums=True)",
               "launches": polished[key], **chk,
               "ms": t["ms"], "plain_ms": t["plain_ms"],
               "bound_ms": t["bound"][0], "bound_by": t["bound"][1],
               "library_ms": None, "shape": shape,
               "no_sums_twin_ms": t["twin_ms"],
               "nearest_library": "none: no call bins against given edges "
                                  "with per-slot sums"}
        if "narrow_ms" in t:
            leg = tkey
            row.update(
                narrow_bracket_ms=t["narrow_ms"],
                uniform_first_sweep_ms=t["ms"],
                polished_first_sweep_ms=t["polished_ms"],
                sweeps_ms={k.split("/", 1)[1]: v for k, v in tk1s.items()
                           if k.split("/", 1)[0] == leg},
                design="first sweeps (full_bracket) of rows of at least "
                       "LANE_SUMS_MIN_N: lane-column f32 tables (K1ws: "
                       "lanes l and l + 16 share a column of (mass, sum) "
                       "pairs, two sub-steps), int counts by shared "
                       "atomics; a slot from a 1024-bucket table (the "
                       "bucket's lowest slot and its edges, decided by the "
                       "realized edges), else counted by the warp from the "
                       "edges its lanes hold; groups of 4 elements read "
                       "16 or 8 bytes at a time where the row is aligned; "
                       "other sweeps, shorter rows and ladders past the "
                       "tables: the grouped rows",
                first_sweep_design="lane_sums", narrow_sweep_design="grouped",
                **lane_build(hbb, leg, f"lane_sums_kernel f32/f32/"
                                       f"{1 if leg == 'k1s' else 2}"))
        else:
            n = ts[tkey.replace("first", "narrow")]
            pf = ts[tkey.replace("first", "polish_first")]
            leg = tkey.split("_")[0]
            row.update(narrow_sweep_ms=n["ms"],
                       narrow_sweep_twin_ms=n["twin_ms"],
                       narrow_sweep_plain_ms=n["plain_ms"],
                       narrow_sweep_bound_ms=n["bound"][0],
                       narrow_sweep_distinct_ladders=n["distinct_ladders"],
                       polished_first_sweep_ms=pf["ms"],
                       polished_first_sweep_twin_ms=pf["twin_ms"],
                       polished_first_sweep_bound_ms=pf["bound"][0],
                       polished_first_sweep_bound_by=pf["bound"][1],
                       polished_first_sweep_distinct_ladders=pf[
                           "distinct_ladders"],
                       design="each chunk of 4096 elements sorted once (CUB "
                              "block radix sort) for all ladders of the "
                              "block; per ladder the slot boundaries by "
                              "searching the edge keys in the sorted chunk, "
                              "each slot a direct sum over its sorted "
                              "positions (strips of 16, the strips' scans "
                              "for the end slots), in an order set by the "
                              "chunk alone; ladders too wide for one a "
                              "block (hist_multi_sums_layout): the grouped "
                              "hist_multi.cu kernel",
                       **hms.get(leg, {}))
        kernels.append(row)
    kernels.append(
        {"name": "sum_blocks (block sums of K2, K4 and the histogram legs "
                 "with rows, weighted legs included)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sum_blocks.cu",
         "replaces": "src/repro/kernels/cp_objective.py:268",
         "replaces_also": ["src/repro/kernels/cp_objective.py:301",
                           "src/repro/kernels/cp_objective.py:351",
                           "src/repro/kernels/cp_objective.py:382"],
         "launches": sb_launches, **sb_check,
         "ms": tsb["ms"], "plain_ms": tsb["plain_ms"],
         "bound_ms": tsb["bound"][0], "bound_by": tsb["bound"][1],
         "library_ms": tsb["plain_ms"],
         "shape": f"{tuple(tsb['shape'])} f32 block partials (K4w, 16 "
                  f"pivots of 2^27)",
         "rows_shape": f"{tuple(tsb['rows_shape'])} (K1w, the rows batch)",
         "rows_ms": tsb["rows_ms"], "rows_plain_ms": tsb["rows_plain_ms"],
         "rows_bound_ms": tsb["rows_bound"][0],
         "launches_per_served_answer": per_served_answer("sum_blocks"),
         "served_shape_rel_err": served_shape["sum_blocks_rel_err_s"],
         "launches_per_train_log": train_log.get("sum_blocks", 0),
         "train_shape_rel_err": train_shape["sum_blocks_rel_err_s"],
         "nearest_library": "torch.sum over the block axis, which is also "
                            "the plain version (so library_ms is plain_ms)"})
    kernels.append(
        {"name": "row_sums (per-row sums of the rows path: total mass, "
                 "means, the finalize's masses)",
         "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sum_blocks.cu",
         "replaces": "src/repro/core/objective.py:304",
         "replaces_also": ["src/repro/core/objective.py:335",
                           "src/repro/core/objective.py:340",
                           "src/repro/core/selection.py:860",
                           "src/repro/core/selection.py:861",
                           "src/repro/core/selection.py:957"],
         "launches": launches["row_sums"], **rs_check,
         "ms": trs["le"]["ms"], "plain_ms": trs["le"]["plain_ms"],
         "bound_ms": trs["le"]["bound"][0], "bound_by": trs["le"]["bound"][1],
         "library_ms": trs["le"]["library_ms"],
         "shape": "(64, 2^20) f32 x and dense f32 w, mass at or below a "
                  "per-row value",
         "sum_of_x_ms": trs["x"]["ms"],
         "sum_of_x_library_ms": trs["x"]["library_ms"],
         "sum_of_x_bound_ms": trs["x"]["bound"][0],
         "rows_alone_equal_batch": rows_ident,
         "launches_per_served_answer": per_served_answer("row_sums"),
         "served_shape_rel_err": served_shape["row_sums_rel_err_s"],
         "launches_per_train_log": train_log.get("row_sums", 0),
         "train_shape_rel_err": train_shape["row_sums_rel_err_s"],
         "nearest_library": "torch.sum(..., dim=1) of the same terms, whose "
                            "order follows the batch"})
    for row in kernels:
        if row["name"] in dist_launches:
            # each sharded answer's launches on one rank (phase 18)
            row["launches_per_sharded_answer"] = dist_launches[row["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
