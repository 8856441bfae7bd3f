"""The port's distributed layer (``repro_torch.core.distributed``,
``objective.ShardedEvaluator``, ``robust.robust_aggregate``) on
``torch.distributed`` over gloo on the CPU, held against the JAX reference
on the same contiguous shards and against numpy oracles.

This file is also the program of its worker processes:

    python tests/test_torch_distributed.py rank R 4 INITFILE OUTDIR

runs rank R of the port's 4-rank gloo world (``file://`` init, one torch
thread) and writes its results to ``OUTDIR/rank{R}.npz``;

    python tests/test_torch_distributed.py reference OUTDIR

runs the reference calls on 4 forced host devices (each call under one
``jax.jit``, its targets as arguments, so they share a compile) and writes
``OUTDIR/ref.npz``.  The module fixture starts the reference process and
the 4 ranks together, waits for every one within
``TIMEOUT`` (a collective that hangs raises after the process group's
60 s timeout), and the tests compare the files:

* against the reference: every ``SelectResult`` field bit for bit for
  'binned' on the counting leg and on integer weights (1-D and K = 8
  deciles) and for the across-axis order statistics ('binned', 'cp');
  value, status and ``n_in`` for 'cp' and 'binned_polish' (their pivots
  and cuts follow the last bits of f32 sums, summed in another order);
  the trimmed mean within 2^-22 relative;
* against numpy oracles and the local engine: cp, polish, auto (to cp
  below 65536), warm starts with adversarial, stale and drifted priors,
  shards of unequal size, ±inf, ties, a 2 x 2 mesh over two groups, the
  'gather' / 'mean' / 'median' aggregations;
* the round counts the reference's workers pin at n = 2^20 on 4 devices
  (``tests/_dist_*_worker.py``), both measures;
* every rank returns the same bits (checked in the workers by gathering
  digests, and here file against file), and two runs agree.
"""
import datetime
import hashlib
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT = 240
FIELDS = ("value", "iters", "status", "y_lo", "y_hi", "n_in")
N = 1 << 17
N_BIG = 1 << 20
KS_1D = (1, N // 10, (N + 1) // 2, N - 3)
W_FRACS = (0.001, 0.5, 0.999)
DECILES = tuple(i / 10.0 for i in range(1, 9))
AXIS_KS = (1, 2, 4)
DENORMAL = 1e-39     # scales data_axis into the denormal range
TRIMS = (0.25, 0.5)  # at 4 replicas: keep all (k_lo = 1), the middle two
CAP = 512          # two binned rounds at n = 2^17 (the default 4096 takes 1)
NBINS_K8, CAP_K8 = 512, 4096   # the reference's one-round decile knobs


# ---------------------------------------------------------------------------
# inputs, the same numpy arrays on both sides
# ---------------------------------------------------------------------------


def data_x(n=N, seed=0):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def data_w(n=N, seed=1, lo=0, hi=5):
    w = np.random.default_rng(seed).integers(lo, hi, n).astype(np.float32)
    w[0] = max(w[0], 1.0)
    return w


def data_axis(scale=1.0):
    """(4 replicas, 4, 33) with the reference worker's ties: a coordinate
    row all 0.5, another equal in both halves of the replicas; times
    ``scale`` (``DENORMAL``: every value a denormal)."""
    v = np.random.default_rng(2).standard_normal((WORLD, 4, 33)).astype(
        np.float32)
    v[:, 1, :] = 0.5
    v[: WORLD // 2, 2, :] = v[WORLD // 2:, 2, :]
    return (v * np.float32(scale)).astype(np.float32)


def data_tree():
    """Per-replica gradient leaves, replica 3 poisoned at 1e6."""
    rng = np.random.default_rng(3)
    g = rng.standard_normal((WORLD, 4, 33)).astype(np.float32)
    h = rng.standard_normal((WORLD, 7)).astype(np.float32)
    g[3], h[3] = 1e6, 1e6
    return {"g": g, "h": h}


def wk_of(w, frac):
    return np.float32(frac * float(w.sum()))


def wdeciles(w):
    W = float(w.sum())
    return np.asarray([np.float32(q * W) for q in DECILES], np.float32)


def ranks_of(qs, n):
    return np.asarray(np.clip(np.ceil(np.asarray(qs, np.float64) * n), 1, n),
                      np.int32)


def os_oracle(x, k):
    return np.partition(x, k - 1)[k - 1]


def wos_oracle(x, w, wk):
    o = np.argsort(x, kind="stable")
    cumw = np.cumsum(w[o].astype(np.float64))
    return x[o][min(np.searchsorted(cumw, wk, "left"), x.size - 1)]


# the reference comparisons: (name, method, weighted); the 1-D ones run
# every target of KS_1D (counting) or W_FRACS (weighted)
REF_1D = (("binned", "binned", False), ("w_binned", "binned", True),
          ("cp", "cp", False), ("w_cp", "cp", True),
          ("polish", "binned_polish", False),
          ("w_polish", "binned_polish", True))
EXACT = ("binned", "w_binned", "deciles", "w_deciles")


# ---------------------------------------------------------------------------
# the reference's side (JAX on 4 forced host devices)
# ---------------------------------------------------------------------------


def reference_main(out: Path) -> None:
    sys.path.insert(0, str(ROOT / "tests"))
    from _dist_env import force_device_count

    force_device_count(WORLD)
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.core import _compat, distributed, robust, selection

    mesh = _compat.make_mesh((WORLD,), ("data",))
    res_spec = jax.tree.map(lambda _: P(), selection.SelectResult(
        *(0,) * 6))
    D = P("data")

    def jit(f, in_specs, out_specs=res_spec):
        return jax.jit(_compat.shard_map(f, mesh=mesh, in_specs=in_specs,
                                         out_specs=out_specs))

    res = {}

    def put(name, r):
        for f in FIELDS:
            res[f"{name}.{f}"] = np.asarray(getattr(r, f))

    x, w = data_x(), data_w()
    for name, method, weighted in REF_1D:
        if weighted:
            fn = jit(lambda xl, wl, k, m=method:
                     distributed.local_order_statistic(
                         xl, k, "data", method=m, cap_local=CAP,
                         weights=wl), (D, D, P()))
            for i, frac in enumerate(W_FRACS):
                put(f"{name}/{i}", fn(x, w, wk_of(w, frac)))
        else:
            fn = jit(lambda xl, k, m=method:
                     distributed.local_order_statistic(
                         xl, k, "data", method=m, cap_local=CAP),
                     (D, P()))
            for i, k in enumerate(KS_1D):
                put(f"{name}/{i}", fn(x, np.int32(k)))
    v, vd = data_axis(), data_axis(DENORMAL)
    for method in ("binned", "cp", "gather"):
        fn = jit(lambda vl, k, m=method:
                 distributed.order_statistic_across_axis(
                     vl, k, "data", method=m), (D, P()), D)
        for k in AXIS_KS:
            if method != "gather":
                res[f"axis_{method}/{k}"] = np.asarray(
                    fn(v, np.int32(k))).reshape(v.shape)[0]
            res[f"denormal_{method}/{k}"] = np.asarray(
                fn(vd, np.int32(k))).reshape(v.shape)[0]
    tree = data_tree()
    for impl in ("gather", "binned"):
        for trim in TRIMS:
            fn = jit(lambda t, i=impl, c=trim: robust.robust_aggregate(
                t, "data", method="trimmed", trim=c, agg_impl=i),
                (D,), D)
            out_t = fn(tree)
            for leaf in ("g", "h"):
                res[f"trimmed_{impl}_{trim}/{leaf}"] = np.asarray(
                    out_t[leaf]).reshape(tree[leaf].shape)[0]
    ks = ranks_of(DECILES, N)
    fn = jit(lambda xl, k: distributed.multi_order_statistic_across_shards(
        xl, k, "data", method="binned"), (D, P()))
    put("deciles", fn(x, ks))
    fn = jit(lambda xl, wl, k:
             distributed.multi_order_statistic_across_shards(
                 xl, k, "data", method="binned", weights=wl),
             (D, D, P()))
    put("w_deciles", fn(x, w, wdeciles(w)))
    np.savez(out / "ref.npz", **res)


# ---------------------------------------------------------------------------
# the port's side (one rank of a 4-rank gloo world)
# ---------------------------------------------------------------------------


def rank_main(rank: int, world: int, init: str, out: Path) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.core import distributed as D
    from repro_torch.core import objective, robust, selection

    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    res = {}

    def shard(a, bounds=None):
        parts = (np.array_split(a, world) if bounds is None
                 else np.split(a, bounds))
        return torch.from_numpy(np.ascontiguousarray(parts[rank]))

    def put(name, r, want=None):
        for f in FIELDS:
            res[f"{name}.{f}"] = getattr(r, f).numpy()
        if want is not None:
            res[f"{name}.want"] = np.asarray(want)

    x, w = data_x(), data_w()
    xl, wl = shard(x), shard(w)

    # -- the reference's calls, on the same contiguous shards ------------
    for name, method, weighted in REF_1D:
        if weighted:
            for i, frac in enumerate(W_FRACS):
                wk = wk_of(w, frac)
                put(f"{name}/{i}", D.sharded_weighted_order_statistic(
                    xl, wl, torch.tensor(wk), mesh, "data", method=method,
                    cap_local=CAP), wos_oracle(x, w, wk))
        else:
            for i, k in enumerate(KS_1D):
                put(f"{name}/{i}", D.sharded_order_statistic(
                    xl, k, mesh, "data", method=method, cap_local=CAP),
                    os_oracle(x, k))
    ks = ranks_of(DECILES, N)
    put("deciles", D.sharded_quantiles(xl, list(DECILES), mesh, "data",
                                       method="binned"),
        np.partition(x, ks - 1)[ks - 1])
    wks = wdeciles(w)
    put("w_deciles", D.sharded_multi_order_statistic(
        xl, torch.from_numpy(wks), mesh, "data", method="binned",
        weights=wl), [wos_oracle(x, w, t) for t in wks])
    v = data_axis()
    vl = torch.from_numpy(v[rank].copy())
    vdl = torch.from_numpy(data_axis(DENORMAL)[rank].copy())
    for method in ("binned", "cp", "gather"):
        for k in AXIS_KS:
            res[f"axis_{method}/{k}"] = D.order_statistic_across_axis(
                vl, k, None, method=method).numpy()
            res[f"denormal_{method}/{k}"] = D.order_statistic_across_axis(
                vdl, k, None, method=method).numpy()
    tree = data_tree()
    tl = {leaf: torch.from_numpy(a[rank].copy()) for leaf, a in tree.items()}
    for impl in ("gather", "binned", "cp"):
        for trim in TRIMS:
            t = robust.robust_aggregate(tl, None, method="trimmed",
                                        trim=trim, agg_impl=impl)
            for leaf in tl:
                res[f"trimmed_{impl}_{trim}/{leaf}"] = t[leaf].numpy()
    for impl in ("gather", "cp", "binned", "auto"):
        t = robust.robust_aggregate(tl, None, method="median", agg_impl=impl)
        for leaf in tl:
            res[f"median_{impl}/{leaf}"] = t[leaf].numpy()
    t = robust.robust_aggregate(tl, None, method="mean")
    for leaf in tl:
        res[f"mean/{leaf}"] = t[leaf].numpy()

    # -- against oracles and the local engine -----------------------------
    k = (N + 1) // 2
    cold = D.sharded_median(xl, mesh, "data", cap_local=CAP)
    put("cold", cold, os_oracle(x, k))
    put("warm", D.sharded_median(xl, mesh, "data", cap_local=CAP,
                                 prior=cold), os_oracle(x, k))
    bad = selection.Prior(value=torch.tensor(float("nan")),
                          y_lo=torch.tensor(float("-inf")),
                          y_hi=torch.tensor(float("inf")),
                          cut=torch.tensor(float("nan")))
    for m in ("binned", "binned_polish", "cp"):
        put(f"adversarial_{m}", D.sharded_median(
            xl, mesh, "data", method=m, cap_local=CAP, prior=bad),
            os_oracle(x, k))
    x3 = (100.0 + 50.0 * data_x(seed=7)).astype(np.float32)
    put("stale", D.sharded_median(shard(x3), mesh, "data", cap_local=CAP,
                                  prior=cold), os_oracle(x3, k))
    x2 = (x + np.float32(1e-4) * data_x(seed=8)).astype(np.float32)
    put("drifted", D.sharded_median(shard(x2), mesh, "data", cap_local=CAP,
                                    prior=cold), os_oracle(x2, k))
    put("warm_cp", D.sharded_median(xl, mesh, "data", method="cp",
                                    cap_local=CAP, prior=cold),
        os_oracle(x, k))
    xs = data_x(1 << 12, seed=9)
    put("auto_small", D.sharded_median(shard(xs), mesh, "data",
                                       method="auto"), os_oracle(xs, 2048))
    put("cp_small", D.sharded_median(shard(xs), mesh, "data", method="cp"),
        os_oracle(xs, 2048))
    # shards of unequal size (one of 10 elements), both legs
    nu = 100_003
    xu, wu = data_x(nu, seed=10), data_w(nu, seed=11)
    bounds = [10, 50_010, 80_010]
    for m in ("binned", "binned_polish", "cp"):
        put(f"unequal_{m}", D.sharded_median(shard(xu, bounds), mesh, "data",
                                             method=m, cap_local=CAP),
            os_oracle(xu, (nu + 1) // 2))
        put(f"unequal_w_{m}", D.sharded_weighted_median(
            shard(xu, bounds), shard(wu, bounds), mesh, "data", method=m,
            cap_local=CAP), wos_oracle(xu, wu, wk_of(wu, 0.5)))
    # +inf in the data, every rank; -inf with it only at the extreme ranks:
    # with -inf every edge but the last is -inf, so an interior rank stalls
    # NOT_CONVERGED, a fault of the reference (ROADMAP Queue 3) that the
    # port keeps, in the local engine as here (pinned below)
    xi = x.copy()
    xi[::1000] = np.inf
    for kq in (1, 200, k, N - 200, N):
        put(f"inf/{kq}", D.sharded_order_statistic(
            shard(xi), kq, mesh, "data", method="binned", cap_local=CAP),
            os_oracle(xi, kq))
    xi[7::1000] = -np.inf
    for kq in (1, N):
        put(f"inf_both/{kq}", D.sharded_order_statistic(
            shard(xi), kq, mesh, "data", method="binned", cap_local=CAP),
            os_oracle(xi, kq))
    put("neginf_fault", D.sharded_order_statistic(
        shard(xi), k, mesh, "data", method="binned", cap_local=CAP))
    loc = selection.order_statistic(torch.from_numpy(xi), k, method="binned",
                                    cap=CAP)
    res["neginf_fault_local.value"] = loc.value.numpy()
    res["neginf_fault_local.status"] = loc.status.numpy()
    xt = np.random.default_rng(12).integers(0, 5, N).astype(np.float32)
    for m in ("binned", "binned_polish", "cp"):
        put(f"ties_{m}", D.sharded_median(shard(xt), mesh, "data", method=m,
                                          cap_local=CAP), os_oracle(xt, k))
    put("ties_quantiles", D.sharded_quantiles(shard(xt), list(DECILES), mesh,
                                              "data"),
        np.partition(xt, ks - 1)[ks - 1])
    # the counting leg equals the local engine on the whole array
    loc = selection.order_statistic(torch.from_numpy(x), k)
    res["local_engine.value"] = loc.value.numpy()
    # one pivot through eval_fg_sharded against eval_fg on the whole array
    y = torch.tensor(float(os_oracle(x, k)))
    fg = D.eval_fg_sharded(xl, y, k, None, None)
    fg0 = objective.eval_fg(torch.from_numpy(x), y, k)
    for f in ("f", "g_lo", "g_hi", "n_lt", "n_le"):
        res[f"eval_fg.{f}"] = np.stack([getattr(fg, f).numpy(),
                                        getattr(fg0, f).numpy()])

    # -- a 2 x 2 mesh over two groups --------------------------------------
    mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("a", "b"))
    for m in ("binned", "cp"):
        put(f"mesh2x2_{m}", D.sharded_median(xl, mesh2, ("a", "b"),
                                             method=m, cap_local=CAP),
            os_oracle(x, k))
    put("mesh2x2_w_binned", D.sharded_weighted_median(
        xl, wl, mesh2, ("a", "b"), cap_local=CAP), wos_oracle(x, w,
                                                              wk_of(w, 0.5)))
    put("mesh2x2_deciles", D.sharded_quantiles(xl, list(DECILES), mesh2,
                                               ("a", "b")),
        np.partition(x, ks - 1)[ks - 1])
    groups = (mesh2.get_group("a"), mesh2.get_group("b"))
    for m in ("binned", "cp", "gather"):
        res[f"mesh2x2_axis_{m}"] = D.order_statistic_across_axis(
            vl, 2, groups, method=m).numpy()

    # -- the round counts the reference's workers pin at 2^20 ------------
    xb = data_x(N_BIG, seed=0)
    wb = data_w(N_BIG, seed=13, lo=1, hi=4)
    xbl, wbl = shard(xb), shard(wb)
    kb = (N_BIG + 1) // 2
    cold_b = D.sharded_median(xbl, mesh, "data", method="binned")
    put("big_binned", cold_b, os_oracle(xb, kb))
    put("big_polish", D.sharded_median(xbl, mesh, "data",
                                       method="binned_polish"),
        os_oracle(xb, kb))
    put("big_warm", D.sharded_median(xbl, mesh, "data", method="binned",
                                     prior=cold_b), os_oracle(xb, kb))
    wkb = wk_of(wb, 0.5)
    wcold = D.sharded_weighted_order_statistic(xbl, wbl, torch.tensor(wkb),
                                               mesh, "data", method="binned")
    put("big_w_binned", wcold, wos_oracle(xb, wb, wkb))
    put("big_w_polish", D.sharded_weighted_order_statistic(
        xbl, wbl, torch.tensor(wkb), mesh, "data", method="binned_polish"),
        wos_oracle(xb, wb, wkb))
    put("big_w_warm", D.sharded_weighted_order_statistic(
        xbl, wbl, torch.tensor(wkb), mesh, "data", method="binned",
        prior=wcold), wos_oracle(xb, wb, wkb))
    ksb = ranks_of(DECILES, N_BIG)
    want_b = np.partition(xb, ksb - 1)[ksb - 1]
    for m in ("binned", "binned_polish"):
        put(f"big_deciles_{m}", D.sharded_quantiles(
            xbl, list(DECILES), mesh, "data", method=m, nbins=NBINS_K8,
            cap_local=CAP_K8), want_b)
    wksb = wdeciles(wb)
    put("big_w_deciles", D.sharded_multi_order_statistic(
        xbl, torch.from_numpy(wksb), mesh, "data", method="binned",
        nbins=NBINS_K8, cap_local=CAP_K8, weights=wbl),
        [wos_oracle(xb, wb, t) for t in wksb])

    # -- two runs agree ----------------------------------------------------
    again = {}
    for name, method, weighted in REF_1D:
        if weighted:
            r = D.sharded_weighted_order_statistic(
                xl, wl, torch.tensor(wk_of(w, W_FRACS[1])), mesh, "data",
                method=method, cap_local=CAP)
            key = f"{name}/1"
        else:
            r = D.sharded_order_statistic(xl, KS_1D[2], mesh, "data",
                                          method=method, cap_local=CAP)
            key = f"{name}/2"
        again[key] = all(_same_bits(getattr(r, f).numpy(),
                                    res[f"{key}.{f}"]) for f in FIELDS)
    res["two_runs_agree"] = np.asarray([again[k] for k in sorted(again)])

    # -- every rank the same bits: gather the digests ----------------------
    digest = hashlib.sha256()
    for key in sorted(res):
        digest.update(key.encode() + np.ascontiguousarray(
            res[key]).tobytes())
    digests = [None] * world
    dist.all_gather_object(digests, digest.hexdigest())
    res["ranks_same_digest"] = np.asarray(len(set(digests)) == 1)
    np.savez(out / f"rank{rank}.npz", **res)
    dist.barrier()
    dist.destroy_process_group()


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


if __name__ == "__main__":
    if sys.argv[1] == "rank":
        rank_main(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                  Path(sys.argv[5]))
    else:
        reference_main(Path(sys.argv[2]))
    sys.exit(0)


# ---------------------------------------------------------------------------
# the tests (pytest imports this module; the workers run it as a script)
# ---------------------------------------------------------------------------

import pytest  # noqa: E402

pytest.importorskip("torch")
pytest.importorskip("jax")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Start the reference process and the port's 4 ranks together; wait
    for all of them within ``TIMEOUT``; return their result files."""
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    ref_env = dict(env, XLA_FLAGS=" ".join(
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count")),
        JAX_PLATFORMS="cpu")
    me = str(Path(__file__).resolve())
    jobs = [(["reference", str(out)], ref_env, "reference")]
    jobs += [(["rank", str(r), str(WORLD), str(out / "init"), str(out)], env,
              f"rank{r}") for r in range(WORLD)]
    procs, logs = [], []
    deadline = time.monotonic() + TIMEOUT
    try:
        for argv, job_env, name in jobs:
            # output to files: no worker can block on a full pipe
            logs.append(out / f"{name}.log")
            with open(logs[-1], "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, me, *argv], env=job_env, stdout=f,
                    stderr=subprocess.STDOUT))
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(log, p.returncode) for p, log in zip(procs, logs)
           if p.returncode != 0]
    if bad:
        pytest.fail("a worker failed or timed out (killed at "
                    f"{TIMEOUT} s):\n" + "\n".join(
                        f"[{log.stem}] rc={rc}\n{log.read_text()[-3000:]}"
                        for log, rc in bad))
    load = lambda name: dict(np.load(out / name))  # noqa: E731
    return {"ranks": [load(f"rank{r}.npz") for r in range(WORLD)],
            "ref": load("ref.npz")}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _cases(port, prefix):
    return sorted({k.split(".")[0] for k in port if k.startswith(prefix)
                   and k.endswith(".value")})


REF_NAMES = tuple(f"{name}/{i}" for name, _, weighted in REF_1D
                  for i in range(len(W_FRACS) if weighted else len(KS_1D))) \
    + ("deciles", "w_deciles")


@pytest.mark.parametrize("case", REF_NAMES)
def test_sharded_against_reference(runs, case):
    """Binned: every field bit for bit (counting and integer weights);
    cp and polish: value, status and n_in."""
    port, ref = runs["ranks"][0], runs["ref"]
    exact = case.split("/")[0] in EXACT
    for f in (FIELDS if exact else ("value", "status", "n_in")):
        np.testing.assert_array_equal(_bits(port[f"{case}.{f}"]),
                                      _bits(ref[f"{case}.{f}"]),
                                      err_msg=f"{case}.{f}")
    np.testing.assert_array_equal(port[f"{case}.value"],
                                  port[f"{case}.want"])


@pytest.mark.parametrize("method", ("binned", "cp"))
def test_across_axis_against_reference(runs, method):
    port, ref = runs["ranks"][0], runs["ref"]
    v = data_axis()
    for k in AXIS_KS:
        got = port[f"axis_{method}/{k}"]
        np.testing.assert_array_equal(_bits(got), _bits(
            ref[f"axis_{method}/{k}"]))
        np.testing.assert_array_equal(got, np.sort(v, axis=0)[k - 1])


@pytest.mark.parametrize("method", ("binned", "cp", "gather"))
def test_denormals_across_axis_the_port_is_right(runs, method):
    """Every replica value a denormal: the port returns np.sort's value on
    every method, bit for bit.  The reference's compiled CPU code flushes
    denormals to zero (its docstring's caveat): its 'binned' and 'cp'
    return a zero (of either sign) for every coordinate, and its 'gather'
    sorts the denormals as zeros, so it returns a replica value, not
    always the k-th.  Pinned on both sides."""
    port, ref = runs["ranks"][0], runs["ref"]
    vd = data_axis(DENORMAL)
    wrong = 0
    for k in AXIS_KS:
        want = np.sort(vd, axis=0)[k - 1]
        got, theirs = port[f"denormal_{method}/{k}"], ref[
            f"denormal_{method}/{k}"]
        np.testing.assert_array_equal(_bits(got), _bits(want))
        if method == "gather":
            assert np.all(np.any(_bits(theirs) == _bits(vd), axis=0))
        else:
            assert np.all(theirs == 0)
        wrong += int(np.sum(_bits(theirs) != _bits(want)))
    assert wrong > 0


@pytest.mark.parametrize("impl", ("gather", "binned"))
@pytest.mark.parametrize("trim", TRIMS)
def test_trimmed_against_reference(runs, impl, trim):
    """The trimmed mean within 2^-22 relative: its f32 sum of the kept
    replicas may be added in another order than the reference's psum."""
    port, ref = runs["ranks"][0], runs["ref"]
    for leaf in ("g", "h"):
        key = f"trimmed_{impl}_{trim}/{leaf}"
        np.testing.assert_allclose(port[key], ref[key], rtol=2.0 ** -22,
                                   atol=0)


def test_trimmed_drops_the_poisoned_replica(runs):
    """trim 0.5 at 4 replicas keeps the middle two values of each
    coordinate (the poisoned replica is the largest); every across-axis
    method gives the same bits."""
    port = runs["ranks"][0]
    for leaf, a in data_tree().items():
        s = np.sort(a, axis=0).astype(np.float64)
        keep = (s >= s[1]) & (s <= s[2])     # ties with the ends kept
        want = np.where(keep, s, 0).sum(axis=0) / keep.sum(axis=0)
        for impl in ("gather", "binned", "cp"):
            got = port[f"trimmed_{impl}_0.5/{leaf}"]
            np.testing.assert_allclose(got, want, rtol=2.0 ** -22)
            np.testing.assert_array_equal(
                got, port[f"trimmed_gather_0.5/{leaf}"])


def test_median_and_mean_aggregation(runs):
    port = runs["ranks"][0]
    for leaf, a in data_tree().items():
        want = np.sort(a, axis=0)[(WORLD + 1) // 2 - 1]
        for impl in ("gather", "cp", "binned", "auto"):
            np.testing.assert_array_equal(port[f"median_{impl}/{leaf}"],
                                          want, err_msg=impl)
        np.testing.assert_allclose(port[f"mean/{leaf}"],
                                   a.astype(np.float64).mean(axis=0),
                                   rtol=1e-6)


def test_gather_across_axis(runs):
    port, v = runs["ranks"][0], data_axis()
    for k in AXIS_KS:
        np.testing.assert_array_equal(port[f"axis_gather/{k}"],
                                      np.sort(v, axis=0)[k - 1])


ORACLE_PREFIXES = ("cold", "warm", "adversarial", "stale", "drifted",
                   "auto_small", "cp_small", "unequal", "inf", "ties",
                   "mesh2x2", "big")


@pytest.mark.parametrize("prefix", ORACLE_PREFIXES)
def test_sharded_against_oracles(runs, prefix):
    """Each value equals its numpy oracle (np.partition, or the f64
    sorted-cumsum mass oracle), and nothing is NOT_CONVERGED."""
    port = runs["ranks"][0]
    cases = [c for c in _cases(port, prefix) if f"{c}.want" in port]
    assert cases
    for c in cases:
        np.testing.assert_array_equal(port[f"{c}.value"], port[f"{c}.want"],
                                      err_msg=c)
        assert not np.any(port[f"{c}.status"] == 3), c


def test_warm_starts_and_auto(runs):
    """A warm re-selection on unchanged data takes one round and returns
    the cold answer's bits (binned: collapse-certified; cp: the prior
    pivot hits); auto below BINNED_MIN_N is method='cp', bit for bit."""
    port = runs["ranks"][0]
    for name in ("warm", "warm_cp"):
        assert int(port[f"{name}.iters"]) == 1, name
        assert int(port[f"{name}.status"]) == 0, name
        assert _same_bits(port[f"{name}.value"], port["cold.value"]), name
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(port[f"auto_small.{f}"]),
                                      _bits(port[f"cp_small.{f}"]))
    assert int(port["drifted.iters"]) <= int(port["cold.iters"])


@pytest.mark.parametrize("name,rounds", (
    ("big_binned", ">=2"), ("big_polish", "1"), ("big_warm", "1"),
    ("big_w_binned", ">=2"), ("big_w_polish", "1"), ("big_w_warm", "1"),
    ("big_deciles_binned", "1"), ("big_deciles_binned_polish", "1"),
    ("big_w_deciles", "1")))
def test_round_counts_pinned_by_the_reference(runs, name, rounds):
    """n = 2^20 on 4 ranks: cold binned >= 2 rounds, binned_polish 1, warm
    1 (``_dist_polish_worker.py``, ``_dist_warm_worker.py``); K = 8
    deciles in 1 round at nbins 512 and cap_local 4096
    (``_dist_multi_k_worker.py``); both measures."""
    it = int(np.max(runs["ranks"][0][f"{name}.iters"]))
    assert it >= 2 if rounds == ">=2" else it == int(rounds), (name, it)


def test_mesh_over_two_groups_equals_one_group(runs):
    """A 2 x 2 mesh (two groups, reduced over in turn) gives the 1-D
    world's bits on the counting leg's binned solve and the across-axis
    answers."""
    port = runs["ranks"][0]
    for f in FIELDS:
        np.testing.assert_array_equal(_bits(port[f"mesh2x2_binned.{f}"]),
                                      _bits(port[f"cold.{f}"]))
    for m in ("binned", "cp", "gather"):
        np.testing.assert_array_equal(port[f"mesh2x2_axis_{m}"],
                                      port[f"axis_{m}/2"])


def test_neginf_fault_reproduced(runs):
    """-inf in the data leaves an interior rank NOT_CONVERGED under
    'binned' (every edge but the last is -inf): the reference's fault,
    which the local engine and the distributed layer both keep."""
    port = runs["ranks"][0]
    assert int(port["neginf_fault.status"]) == 3
    for f in ("value", "status"):
        assert _same_bits(port[f"neginf_fault.{f}"],
                          port[f"neginf_fault_local.{f}"]), f


def test_local_engine_and_eval_fg_sharded(runs):
    port = runs["ranks"][0]
    np.testing.assert_array_equal(port["local_engine.value"],
                                  port["cold.value"])
    for f in ("n_lt", "n_le"):
        a = port[f"eval_fg.{f}"]
        assert a[0] == a[1], f
    for f in ("f", "g_lo", "g_hi"):
        a = port[f"eval_fg.{f}"].astype(np.float64)
        np.testing.assert_allclose(a[0], a[1], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("rank", range(1, WORLD))
def test_every_rank_holds_the_same_bits(runs, rank):
    ranks = runs["ranks"]
    assert bool(ranks[rank]["ranks_same_digest"])
    assert sorted(ranks[rank]) == sorted(ranks[0])
    for k in ranks[0]:
        assert _same_bits(ranks[rank][k], ranks[0][k]), k


def test_two_runs_agree(runs):
    assert np.all(runs["ranks"][0]["two_runs_agree"])
