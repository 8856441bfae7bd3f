"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. device: the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/kernels/csrc`` (one nvcc per source, in parallel);
2. K1 (row histogram) against its plain version on the card, counts equal
   bit for bit, at the main path's (1, 2^27) and (64, 2^20) and at an n
   that is a multiple of no grid stride (``K1_SHAPES``), f32 and bf16,
   with ±inf, NaN, signed zeros and denormals in the data and full-range,
   data-scale, narrow, duplicated-edge and denormal edge ladders;
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
   (2^27, 16), (50,000, 16) and (``N_ODD``, 64), and K = 1 through
   ``cp_partials``: counts equal, sums within ``SUM_RTOL``;
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
   kernel, its plain version and its bound; the median, ``select_rows``
   and the 16 quantiles end to end with ``torch.kthvalue`` / ``torch.sort``
   (plus a gather) as yardsticks that the port never calls, and the 16
   quantiles also against 16 separate ``order_statistic`` calls; a
   breakdown of the 2^27 median and of the 16 quantiles.

The line before the last two is ``{"kernels": [...]}``; then the
``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
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


def check_k1(cpo, ref) -> dict:
    """K1 counts against the plain version; returns the largest
    |kernel - plain| count difference (it raises unless that is 0)."""
    kinds = bracket_kinds()
    worst = 0
    for dtype in (torch.float32, torch.bfloat16):
        for rows, n, seed in K1_SHAPES:
            x = special_data(rows, n, seed).to(dtype)
            # one ladder per row for the batch, each ladder in turn for B = 1
            ladders = ([[kinds[i % len(kinds)] for i in range(rows)]]
                       if rows > 1 else [[kind] for kind in kinds])
            for ladder in ladders:
                e = edge_ladders(ref, ladder, 128)
                got, _ = cpo.cp_histogram_batched(x, e)
                want, _ = ref.cp_histogram_batched_ref(x, e, want_sums=False)
                torch.cuda.synchronize()
                worst = max(worst, int((got - want).abs().max()))
                if not torch.equal(got, want):
                    raise AssertionError(f"K1 counts differ from the plain "
                                         f"version: ({rows}, {n}) {dtype} "
                                         f"{ladder[:5]}")
                assert torch.all(got.sum(dim=1) == n)
            del x
    log(f"K1 hist_batched == plain version bit for bit at (rows, n) "
        f"{[s[:2] for s in K1_SHAPES]}, 5 edge ladders, f32 and bf16, with "
        f"inf/NaN/denormals")
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
                           (N_ODD, 64, 25)):
            for special in (True, False):
                if special:
                    x = special_data(1, n, seed)[0]
                else:
                    x = torch.randn(n, generator=gen(seed + 10),
                                    device=DEVICE)
                x = x.to(dtype)
                y = pivots[torch.arange(k, device=DEVICE) % pivots.numel()]
                y[-1] = x[12345].float()  # a pivot on a data value
                label = f"n={n} K={k} {dtype} special={special}"
                compare(cpo.cp_partials_multi(x, y),
                        ref.cp_partials_multi_ref(x, y), label)
                got = cpo.cp_partials(x, y[-1])
                compare([g[None] for g in got],
                        ref.cp_partials_multi_ref(x, y[-1:]),
                        label + " K=1")
                del x
    log(f"K4 fg_multi == plain version: counts bit for bit, sums within "
        f"rtol {SUM_RTOL} (worst {worst_rel:.3g}), (n, K) (2^27, 16), "
        f"({N_SMALL}, 16), ({N_ODD}, 64) and K=1 (cp_partials), f32 and "
        f"bf16, with and without inf/NaN/denormals")
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


def bound(nbytes, ops):
    """The least time for ``nbytes`` of traffic and ``ops`` f32 operations,
    and which of the two bounds it."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def timings(sel, cpo, ref, obj) -> dict:
    out = {}
    x = torch.randn((1, N_BIG), generator=gen(8), device=DEVICE)
    e1 = ref.bin_edges(x.min(), x.max(), 128)[None, :].contiguous()
    # K1 at the first sweep's full-data bracket (every element in bracket)
    k1 = cuda_ms(lambda: cpo.cp_histogram_batched(x, e1), reps=20)
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
    out["k1_rows_ms"] = cuda_ms(lambda: cpo.cp_histogram_batched(xr, er),
                                reps=20)
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
    # K4 at 16 pivots on the data's quantiles
    y = torch.sort(x).values[ks.long() - 1]
    nblk = cpo.fg_blocks(N_BIG)
    out["k4"] = dict(
        ms=cuda_ms(lambda: cpo.cp_partials_multi(x, y), reps=20),
        plain_ms=cuda_ms(lambda: ref.cp_partials_multi_ref(x, y), reps=1,
                         rounds=3),
        bound=bound(N_BIG * 4 + 16 * 4 + nblk * 16 * 16, 7 * 16 * N_BIG))

    # end to end
    out["quantiles_ms"] = cuda_ms(lambda: sel.quantiles(x, QS16), reps=1,
                                  rounds=5)
    out["sort_gather_ms"] = cuda_ms(
        lambda: torch.sort(x).values[ks.long() - 1], reps=1, rounds=5)
    ks_host = [int(k) for k in ks.cpu()]
    out["sixteen_order_statistic_ms"] = cuda_ms(
        lambda: [sel.order_statistic(x, k) for k in ks_host], reps=1,
        rounds=3, warmup=1)
    out["multi_cp_ms"] = cuda_ms(
        lambda: sel.multi_order_statistic(x, ks, method="cp"), reps=1,
        rounds=3)

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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA GPU: "
                         "torch.cuda.is_available() is false")
    from repro_torch.core import objective as obj
    from repro_torch.core import selection as sel
    from repro_torch.kernels import _build
    from repro_torch.kernels import cp_objective as cpo
    from repro_torch.kernels import ref

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} | {smi} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t_build = _build.build_all()
    log(f"built {', '.join(_build.SOURCES)} in {t_build:.1f} s")
    for src, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {src}: {line.strip()}")

    t0 = time.perf_counter()
    k1_check = check_k1(cpo, ref)
    k2_check = check_k2(cpo, ref)
    k3_check = check_k3(cpo, ref)
    k4_check = check_k4(cpo, ref)
    log(f"kernel checks took {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches = main_path(sel, cpo)
    multi = multi_k_path(sel, cpo)
    log(f"main paths took {time.perf_counter() - t0:.1f} s; launches "
        f"rows/scalar {launches}, multi-k {multi}")
    for key, count in (("cp_histogram_batched", launches),
                       ("cp_partials_batched", launches),
                       ("cp_histogram_multi", multi),
                       ("cp_partials_multi", multi)):
        if count[key] == 0:
            raise AssertionError(f"{key} never launched on its main path")

    t0 = time.perf_counter()
    tm = timings(sel, cpo, ref, obj)
    tmm = timings_multi(sel, cpo, ref, obj)
    log(f"timings took {time.perf_counter() - t0:.1f} s")
    log("timings (ms, " + name + ", " + smi + "): " + json.dumps(tm))
    log("multi-k timings (ms, " + name + ", " + smi + "): "
        + json.dumps(tmm))

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
         "narrow_bracket_ms": tm["k1"]["narrow_ms"],
         "rows_64x2^20_ms": tm["k1_rows_ms"],
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
         "nearest_library": "none: no PyTorch call returns the partials of "
                            "K pivots from one read of the array"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
