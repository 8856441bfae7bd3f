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
   column alone bit for bit);
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
   per block, past 48 KB of shared memory) and with K = 1 through
   ``cp_histogram``;
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
   weights: each of 16 ladders alone (the first sweep's identical ones,
   and the distinct narrow ones a descent step picks) equals its entry
   among the 16, and a permutation of the 16 changes nothing; K4w also
   at (``N_ODD``, 17) with non-finite pivots, with the launch identities
   of phase 5 (against K2w) on integer and dense weights;
9. the weighted paths at full size through their public entry points, the
   launch counts of each run read from zero and only the weighted kernels
   allowed to launch: ``weighted_median`` of n = 2^27 f32 with 0/1 weights
   at density 1/16 (K1w; every mass exact, so the value equals a
   ``torch.sort`` + f64 cumulative-mass oracle bit for bit), the same with
   dense weights (checked by a mass interval of stated width), a bf16-x
   median, ``weighted_select_rows`` on (64, 2^20) with integer weights,
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
   (``hist_multi.cu``) against their plain versions at the K1 and K3
   shapes above (``N_ODD``, K = 64, 8192 bins and the K = 1 views
   included), x and w each f32 and bf16: counts, masses and sums bit for
   bit on integer data whose slot totals stay below 2^24, with ±inf, NaN
   and ±0 planted (NaN and inf slots equal with ``equal_nan``); on randn
   with the SPECIALS each slot sum within ``f32_chain`` * 2^-24 of the f64
   plain version (relative to the slot's sum of |values|); two launches
   identical;
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
   plain version; the polished median, rows batch and 16 quantiles against
   their 'binned' twins with sweeps per answer; one warm tracker tick
   against a cold median on the same tick's data, each with a stats /
   loop / finalize breakdown.

Every pass with f32 block partials (K2, K4, and the histogram legs with
rows: K1w, K1s, K1ws, K3w, K3s, K3ws) sums them with one ``sum_blocks``
launch, and the main paths' launch counts are held to that.

The line before the last two is ``{"kernels": [...]}`` (all twelve kernel
legs: K1-K4, their weighted legs K1w-K4w, and the sums legs K1s, K1ws,
K3s, K3ws; and ``sum_blocks``, the block sums of every leg with f32
partials; K1's and K1w's rows with first- and narrow-sweep times, their
registers, shared memory and blocks per SM); then the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import ctypes
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


def k1_designs(cpo, nedges: int, nrows: int, n: int):
    """The ``full_bracket`` values that reach distinct designs of K1
    (``nrows`` 0), K1w/K1s (1) or K1ws (2) at this call."""
    if not full_kw(cpo):
        return [False]
    lay = {f: cpo.hist_rows_layout(nedges, nrows, n, f) for f in (False,
                                                                  True)}
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
        for label, ladder in (("16 identical", [kinds[1]] * 16),
                              ("5 kinds cycled over 16",
                               [kinds[j % 5] for j in range(16)])):
            e = edge_ladders(ref, ladder, 128)
            got, _ = cpo.cp_histogram_multi(x, e)
            want, _ = ref.cp_histogram_multi_ref(x, e, want_sums=False)
            compare(got, want, f"n=2^27 {dtype} {label}")
            assert torch.all(got.sum(dim=1) == N_BIG)
        del x
        x = special_data(1, N_ODD, 22)[0].to(dtype)
        for k, nbins in ((64, 128), (3, 8192)):
            e = edge_ladders(ref, [kinds[j % 5] for j in range(k)], nbins)
            got, _ = cpo.cp_histogram_multi(x, e)
            want, _ = ref.cp_histogram_multi_ref(x, e, want_sums=False)
            compare(got, want, f"n={N_ODD} {dtype} K={k} nbins={nbins}")
        for kind in kinds:
            e1 = edge_ladders(ref, [kind], 128)[0]
            got, _ = cpo.cp_histogram(x, e1)
            want, _ = ref.cp_histogram_ref(x, e1, want_sums=False)
            compare(got, want, f"n={N_ODD} {dtype} K=1 {kind}")
    log(f"K3 hist_multi == plain version bit for bit at n=2^27 K=16 "
        f"(identical and cycled ladders), n={N_ODD} K=64, K=3 at 8192 bins "
        f"and K=1 (cp_histogram), f32 and bf16, with inf/NaN/denormals")
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


def rows_alone_equal_batch(cpo, ref, check: bool = True) -> bool:
    """K1w at n = N_IDENT (1024 block partials) with dense weights, 16
    rows on their first sweep's ladders: whether each row alone gives the
    same counts and masses, bit for bit, as its entry in the batch (raises
    if not, with ``check``)."""
    x = torch.randn((16, N_IDENT), generator=gen(301), device=DEVICE)
    wd = dense_weights((16, N_IDENT), 302)
    e = first_sweep_edges(ref, x, 128)
    same = True
    for full in k1_designs(cpo, e.shape[1], 1, N_IDENT):
        kw = full_kw(cpo, full)
        cnt, mass, _ = cpo.wcp_histogram_batched(x, wd, e, **kw)
        for r in range(16):
            c1, m1, _ = cpo.wcp_histogram_batched(x[r:r + 1], wd[r:r + 1],
                                                  e[r:r + 1], **kw)
            same &= torch.equal(cnt[r:r + 1], c1) and same_bits(
                mass[r:r + 1], m1)
    if check and not same:
        raise AssertionError("K1w: a row alone differs from its entry in a "
                             "batch of 16 (1024 blocks, dense weights)")
    return same


def ladders_alone_equal_among_16(cpo, ref, sel, check: bool = True) -> dict:
    """K3w at n = N_IDENT (1024 block partials) with dense weights: whether
    each of 16 ladders alone gives the same counts and masses, bit for bit,
    as its entry among the 16, and a permutation of the 16 the same as the
    16 permuted: on the first sweep's 16 identical ladders and on the
    distinct narrow ladders a descent step picks for 16 quantiles (raises
    if not, with ``check``), and, reported only, on the five bracket kinds
    cycled over 16 (overlapping ladders: an element inside several is
    grouped per ladder in a round that depends on the ladders before it,
    so their masses may follow their company)."""
    x = torch.randn(N_IDENT, generator=gen(303), device=DEVICE)
    wd = dense_weights(N_IDENT, 304)
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].expand(16, -1)
    e1 = e1.contiguous()
    ks = sel.ranks_from_quantiles(QS16, N_IDENT).to(DEVICE)
    cnt1 = cpo.cp_histogram_multi(x, e1)[0]
    cum = torch.cumsum(cnt1[:, :-1], dim=-1, dtype=torch.int32)
    yl, yr, *_ = sel.binned_descent_step(cum, e1, e1[:, 0], e1[:, -1], ks)
    kinds = bracket_kinds()
    cases = {"first sweep": e1,
             "narrow": ref.bin_edges(yl, yr, 128).contiguous(),
             "5 kinds cycled": edge_ladders(ref, [kinds[j % 5]
                                                  for j in range(16)], 128)}
    perm = torch.randperm(16, generator=gen(305), device=DEVICE)
    out = {}
    for label, e in cases.items():
        cnt, mass, _ = cpo.wcp_histogram_multi(x, wd, e)
        same = True
        for j in range(16):
            c1, m1, _ = cpo.wcp_histogram(x, wd, e[j])
            same &= torch.equal(cnt[j], c1) and same_bits(mass[j], m1)
        cp, mp, _ = cpo.wcp_histogram_multi(x, wd, e[perm].contiguous())
        same &= torch.equal(cnt[perm], cp) and same_bits(mass[perm], mp)
        out[label] = same
        if check and label != "5 kinds cycled" and not same:
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


def check_k3w(cpo, ref, sel) -> dict:
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
                got = cpo.wcp_histogram_multi(x, wi, e)[:2]
                want = ref.wcp_histogram_multi_ref(x, wi, e,
                                                   want_sums=False)[:2]
                chk.exact(got, want, f"n={n} {xdt} {wdt} {label}")
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
    ident = ladders_alone_equal_among_16(cpo, ref, sel)
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
    once per sweep or pass."""
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
    # a pass with f32 block partials sums them with sum_blocks
    block_sums = (launches[expect_kernel] if has_block_sums(expect_kernel)
                  else 0)
    if (moved - {"sum_blocks"} != {expect_kernel}
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
        out[label] = dict(
            ms=cuda_ms(lambda: cpo.wcp_histogram_multi(x, wd, e), reps=20),
            plain_ms=cuda_ms(lambda: ref.wcp_histogram_multi_ref(
                x, wd, e, want_sums=False), reps=1, rounds=3),
            # + the weights read once, the mass output, and two selected
            # mass adds per element and distinct ladder
            bound=bound(nbytes + N_BIG * 4 + c.numel() * 4,
                        ops + 2 * N_BIG * distinct),
            distinct_ladders=distinct)
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


def check_sums_rows(cpo, ref) -> tuple:
    """K1s and K1ws against their plain versions at the K1 shapes."""
    kinds = bracket_kinds()
    c1s, c1ws = SumsCheck("K1s"), SumsCheck("K1ws")
    for rows, n, seed in K1_SHAPES:
        ladders = ([[kinds[i % len(kinds)] for i in range(rows)]]
                   if rows > 1 else [[kind] for kind in kinds])
        xi = int_sparse_data(rows, n, seed + 100)
        wi = int_weights((rows, n), seed + 101)
        for ladder in ladders:
            e = edge_ladders(ref, ladder, 128)
            for xdt in (torch.float32, torch.bfloat16):
                x = xi.to(xdt)
                for full in k1_designs(cpo, e.shape[1], 1, n):
                    c1s.exact(cpo.cp_histogram_batched(
                        x, e, want_sums=True, **full_kw(cpo, full)),
                        ref.cp_histogram_batched_ref(x, e, want_sums=True),
                        f"({rows}, {n}) {xdt} {ladder[:3]} full={full}")
            for xdt, wdt in WDTYPES:
                x, w = xi.to(xdt), wi.to(wdt)
                c1ws.exact(cpo.wcp_histogram_batched(x, w, e, want_sums=True),
                           ref.wcp_histogram_batched_ref(x, w, e,
                                                         want_sums=True),
                           f"({rows}, {n}) {xdt} {wdt} {ladder[:3]}")
        del xi, wi
        x = special_data(rows, n, seed + 102)
        wd = dense_weights((rows, n), seed + 103)
        chain = f32_chain(cpo, n)
        plain = ref.wcp_histogram_batched_ref
        for ladder in ladders:
            e = edge_ladders(ref, ladder, 128)
            for full in k1_designs(cpo, e.shape[1], 1, n):
                got = cpo.cp_histogram_batched(x, e, want_sums=True,
                                               **full_kw(cpo, full))
                c1s.near(got[1], *f64_sums(plain, x, None, e), got[0],
                         chain, f"({rows}, {n}) {ladder[:3]} full={full}")
            got = cpo.wcp_histogram_batched(x, wd, e, want_sums=True)
            c1ws.near(got[2], *f64_sums(plain, x, wd, e), got[0], chain,
                      f"({rows}, {n}) {ladder[:3]}")
            for full in k1_designs(cpo, e.shape[1], 1, n):
                c1s.repeat(lambda: cpo.cp_histogram_batched(
                    x, e, want_sums=True, **full_kw(cpo, full)),
                    f"({rows}, {n}) full={full}")
            c1ws.repeat(lambda: cpo.wcp_histogram_batched(x, wd, e,
                                                          want_sums=True),
                        f"({rows}, {n})")
        del x, wd
    log(f"K1s/K1ws hist_batched sums legs == plain version: counts, masses "
        f"and sums bit for bit on integer data with inf/NaN/±0 (x and w "
        f"each f32 and bf16), randn sums within {c1s.bound:.3g} of f64 "
        f"(worst {c1s.rel:.3g} / {c1ws.rel:.3g} of the slot's |sum|), two "
        f"launches identical, (rows, n) {[s[:2] for s in K1_SHAPES]}")
    return c1s.result(), c1ws.result()


def check_sums_multi(cpo, ref) -> tuple:
    """K3s and K3ws against their plain versions at the K3 shapes."""
    kinds = bracket_kinds()
    c3s, c3ws = SumsCheck("K3s"), SumsCheck("K3ws")
    cases = ((N_BIG, 121, [("16 identical", [kinds[1]] * 16, 128),
                           ("5 kinds cycled over 16",
                            [kinds[j % 5] for j in range(16)], 128)]),
             (N_ODD, 122, [("K=64", [kinds[j % 5] for j in range(64)], 128),
                           ("K=3 at 8192 bins", [kinds[j] for j in range(3)],
                            8192)]))
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
        chain = f32_chain(cpo, n)
        plain = ref.wcp_histogram_multi_ref
        for label, ladder, nbins in ladders:
            e = edge_ladders(ref, ladder, nbins)
            got = cpo.cp_histogram_multi(x, e, want_sums=True)
            c3s.near(got[1], *f64_sums(plain, x, None, e), got[0], chain,
                     f"n={n} {label}")
            got = cpo.wcp_histogram_multi(x, wd, e, want_sums=True)
            c3ws.near(got[2], *f64_sums(plain, x, wd, e), got[0], chain,
                      f"n={n} {label}")
            c3s.repeat(lambda: cpo.cp_histogram_multi(x, e, want_sums=True),
                       f"n={n} {label}")
            c3ws.repeat(lambda: cpo.wcp_histogram_multi(x, wd, e,
                                                        want_sums=True),
                        f"n={n} {label}")
        del x, wd
    log(f"K3s/K3ws hist_multi sums legs == plain version: counts, masses and "
        f"sums bit for bit on integer data with inf/NaN/±0 at n=2^27 K=16 "
        f"(identical and cycled ladders), n={N_ODD} K=64, K=3 at 8192 bins "
        f"and K=1 (cp_histogram / wcp_histogram), x and w each f32 and bf16; "
        f"randn sums within {c3s.bound:.3g} of f64 (worst {c3s.rel:.3g} / "
        f"{c3ws.rel:.3g}), two launches identical")
    return c3s.result(), c3ws.result()


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
            and launched == {"cp_histogram_batched": 1}
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
    # the first sweep's ladder e1 holds every element (full_bracket)
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
        nbytes, ops = k3_work(x, e, c)
        distinct = len({r.numpy().tobytes() for r in e.cpu()})
        out[f"k3s_{label}"] = dict(
            ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, e, want_sums=True),
                       reps=20),
            twin_ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, e), reps=20),
            plain_ms=cuda_ms(lambda: ref.cp_histogram_multi_ref(
                x, e, want_sums=True), reps=1, rounds=3),
            # + the sums output and two selected adds per element and
            # distinct ladder
            bound=bound(nbytes + c.numel() * 4, ops + 2 * N_BIG * distinct),
            distinct_ladders=distinct)
        out[f"k3ws_{label}"] = dict(
            ms=cuda_ms(lambda: cpo.wcp_histogram_multi(x, wd, e,
                                                       want_sums=True),
                       reps=20),
            twin_ms=cuda_ms(lambda: cpo.wcp_histogram_multi(x, wd, e),
                            reps=20),
            plain_ms=cuda_ms(lambda: ref.wcp_histogram_multi_ref(
                x, wd, e, want_sums=True), reps=1, rounds=3),
            # + w read once, masses and sums out, a product per element and
            # four selected adds per element and distinct ladder
            bound=bound(nbytes + N_BIG * 4 + 2 * c.numel() * 4,
                        ops + N_BIG + 4 * N_BIG * distinct),
            distinct_ladders=distinct)

    # the polished multi-k first sweep: every target's ladder spans
    # [min, max] but centres half its edges on its own seed cut, so the 16
    # ladders are distinct and every element lies inside all 16
    ev = obj.SharedEvaluator(x, ks)
    s0, xmin, xmax, kk, _, xmean = sel._seed_state(ev)
    cut0 = sel._seed_cut(ev, kk, xmin, xmax, xmean)
    bad = ~torch.isfinite(cut0) | (cut0 <= s0.yL) | (cut0 >= s0.yR)
    tp = torch.where(bad, 0.5 * (s0.yL + s0.yR), cut0)
    ep = sel.polish_edges(s0.yL, s0.yR, tp, 128).contiguous()
    cntp, _ = cpo.cp_histogram_multi(x, ep)
    nbytes, ops = k3_work(x, ep, cntp)
    distinct = len({r.numpy().tobytes() for r in ep.cpu()})
    out["k3s_polish_first"] = dict(
        ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, ep, want_sums=True),
                   reps=5),
        twin_ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, ep), reps=5),
        bound=bound(nbytes + cntp.numel() * 4, ops + 2 * N_BIG * distinct),
        distinct_ladders=distinct)
    cap = sel._default_cap_rows(N_BIG)
    for tag, polish in (("binned", False), ("polish", True)):
        out[f"quantiles_{tag}_loop_ms"] = cuda_ms(
            lambda: sel.binned_loop_batched(ev, nbins=128, cap=cap,
                                            polish=polish), reps=1, rounds=3)
        s, xmin, xmax = sel.binned_loop_batched(ev, nbins=128, cap=cap,
                                                polish=polish)
        out[f"quantiles_{tag}_finalize_ms"] = cuda_ms(
            lambda: sel._finalize_shared(ev.x, ev.k, s, cap, xmin, xmax),
            reps=1, rounds=3)
    del ev

    # polished answers against 'binned', with sweeps per answer
    xr = torch.randn((ROWS, N_ROW), generator=gen(153), device=DEVICE)
    kr = torch.randint(1, N_ROW + 1, (ROWS,), generator=gen(154),
                       device=DEVICE)
    for label, call in (
            ("median", lambda m: sel.median(x, method=m)),
            ("rows", lambda m: sel.select_rows(xr, kr, method=m)),
            ("quantiles", lambda m: sel.quantiles(x, QS16, method=m))):
        for m in ("binned", "binned_polish"):
            tag = f"{label}_{'polish' if m == 'binned_polish' else 'binned'}"
            out[f"{tag}_ms"] = cuda_ms(lambda: call(m), reps=1,
                                       rounds=3 if label == "quantiles"
                                       else 5)
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
        out[label] = dict(
            ms=cuda_ms(lambda: cpo.cp_histogram_multi(x, e), reps=20),
            plain_ms=cuda_ms(lambda: ref.cp_histogram_multi_ref(
                x, e, want_sums=False), reps=1, rounds=3),
            bound=bound(*k3_work(x, e, cnt)),
            distinct_ladders=len({r.numpy().tobytes() for r in e.cpu()}))
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
    (lane_rows_kernel legs 1 K1w, 2 K1s; whist_batched_kernel legs 0 K1w,
    1 K1s, 2 K1ws; W is T and leg "-" where the kernel has none), or None
    for another function."""
    m = re.search(r"\d+(lane_count_kernel|lane_rows_kernel|"
                  r"whist_batched_kernel|hist_batched_kernel)"
                  r"I(f|13__nv_bfloat16)"
                  r"(f|13__nv_bfloat16|S\w*?_)?(?:Li(\d)E)?E", mangled)
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
        for leg, name, nrows in ((0, "k1", 0), (1, "k1w", 1), (2, "k1s", 1)):
            blocks = ctypes.c_int(0)
            rc = fn(leg, 129, cpo.LANE_WARPS, ctypes.byref(blocks))
            if rc != 0:
                raise RuntimeError(f"occupancy query of {name} failed: CUDA "
                                   f"error {rc}")
            out[name] = {"smem_bytes": cpo.lane_hist_smem(129, nrows),
                         "warps": cpo.LANE_WARPS,
                         "blocks_per_sm": blocks.value,
                         "grid_blocks_per_sm": cpo.blocks_per_sm(
                             cpo.lane_hist_smem(129, nrows))}
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


def compare_times(sel, cpo, obj, ref, _build) -> dict:
    """What ``--compare`` reads from each tree: the two cp solves
    (``cp_solves``); K2 and K2w at one pivot on 2^27; K4 and K4w at K in
    ``KS_SWEEP`` with x and w each f32 and bf16; whether each of 16 pivots
    alone gets the same bits as among the 16, at 1024 blocks with dense
    weights; fg_multi's build report; ``sum_blocks``'s device time at
    four shapes of its launches; K1 and K1w at the first and narrow
    sweeps (``hist_rows_times``), the row histogram's main path end to end
    (``rows_path_times``), hist_batched's build report, whether a K1w row
    alone and a K3w ladder alone get the same bits as in company; and the
    outputs of K4/K4w and K1w for ``compare_outputs``."""
    parts = {str(list(sh)): torch.rand(sh, generator=gen(211), device=DEVICE)
             for sh in (sum_blocks_shapes(cpo)[i] for i in (1, 5, 8, 9))}
    out = {"sum_blocks_device_ms": {k: graph_ms(lambda: cpo._sum_blocks(v))
                                    for k, v in parts.items()},
           "k1_ms": hist_rows_times(cpo, ref, False),
           "k1w_ms": hist_rows_times(cpo, ref, True),
           "rows_path": rows_path_times(sel, obj),
           "hist_build": hist_batched_build(_build, cpo),
           "k1w_row_alone_equals_batch": rows_alone_equal_batch(
               cpo, ref, check=False),
           "k3w_ladder_alone_equals_among_16": ladders_alone_equal_among_16(
               cpo, ref, sel, check=False)}
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
    try:
        out["build"] = fg_multi_build(_build)
    except Exception as e:  # a tree whose build this parser does not read
        out["build"] = f"not read: {e!r}"
    return out


def compare_outputs(a: dict, b: dict) -> dict:
    """Two trees' ``compare_times`` outputs: whether the counts (and the
    masses with integer weights) are equal, and per leg (k4, k4w, k1w) how
    many f32 sums or dense masses carry the same bits and the largest
    relative difference of the others."""
    exact, legs = True, {}
    for case, outs in a.items():
        # K4 (two sums, two counts), K4w (four sums, two counts), K1w
        # (counts, then masses): which outputs are integers
        if case.startswith("k1w "):
            ints = (0,) if "dense" in case else (0, 1)
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--compare", type=Path, metavar="TREE",
                    help="time this tree against the repository copy TREE "
                         "instead of running the checks")
    ap.add_argument("--times-of", type=Path, metavar="SRC",
                    help="print, as one JSON line, what --compare reads, "
                         "with the package under SRC")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is false")
    sys.path.insert(0, str(args.times_of or ROOT / "src"))
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
    k1_check = check_k1(cpo, ref)
    k2_check = check_k2(cpo, ref)
    k3_check = check_k3(cpo, ref)
    k4_check = check_k4(cpo, ref)
    w_checks = [check_k1w(cpo, ref), check_k2w(cpo, ref),
                check_k3w(cpo, ref, sel), check_k4w(cpo, ref)]
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
    hbb = hist_batched_build(_build, cpo)
    log(f"timings took {time.perf_counter() - t0:.1f} s")
    log("K1/K1w sweeps (ms, " + name + ", " + smi + "): " + json.dumps(tk1))
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
    s_checks = [*check_sums_rows(cpo, ref), *check_sums_multi(cpo, ref)]
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
    log(f"polish/warm timings took {time.perf_counter() - t0:.1f} s")
    log("polish and warm timings (ms, " + name + ", " + smi + "): "
        + json.dumps({**ts, **warm}))

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
         "rows_64x2^20_ms": tm["k2_rows_ms"]},
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
            row.update(narrow_sweep_ms=tw["k3w_narrow"]["ms"],
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
        ("shist_multi (K3s)", "hist_multi.cu", 197, "cp_histogram_multi_sums",
         "k3s_first", "(2^27,) f32, K=16 identical first-sweep ladders, 128 "
         "bins, counts and sums of x"),
        ("wshist_multi (K3ws)", "hist_multi.cu", 197,
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
            row["narrow_bracket_ms"] = t["narrow_ms"]
        else:
            n = ts[tkey.replace("first", "narrow")]
            row.update(narrow_sweep_ms=n["ms"],
                       narrow_sweep_twin_ms=n["twin_ms"],
                       narrow_sweep_plain_ms=n["plain_ms"],
                       narrow_sweep_bound_ms=n["bound"][0],
                       narrow_sweep_distinct_ladders=n["distinct_ladders"])
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
         "nearest_library": "torch.sum over the block axis, which is also "
                            "the plain version (so library_ms is plain_ms)"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
