"""The port's serving path held against the JAX reference on the CPU.

* ``repro_torch.launch.serve.serve`` (the launcher's loop) on phi3-mini
  (the launcher's default arch) and gemma2 (ring caches wrapping, softcaps,
  tied embeddings), ``.reduced()``, B = 4, prompt 16, gen 16: its greedy
  tokens equal those of the reference launcher's loop on the same weights
  (numpy draws, through ``convert.params_from_numpy``), and the reference's
  top-2 logit margin at every step exceeds twice the logits' tolerance
  (``TOL`` times their largest magnitude, as tests/test_torch_models.py
  holds them), so the equality is no near-tie broken the same way by
  chance;
* the latency percentiles through the port's selection against
  ``np.sort`` (exact: the same f32 value), and on the served latencies
  every field of the reference's ``median`` / ``quantile`` (the ~29
  latencies fit the cap, so both certify them with no cp pass);
* the entry points place their tensors on the card unless given
  ``device="cpu"``, and raise without a GPU;
* the families the port does not run yet raise ``NotImplementedError``
  before anything is allocated or computed;
* the launcher's CLI and the example, and the serving path in a fresh
  interpreter where ``import jax`` fails;
* ``repro_torch.convert``, the selection callers' crossing point, loads
  no model layer until ``params_from_numpy`` is called.
"""
import runpy
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import selection as jsel  # noqa: E402
from repro.configs import local_plan as jlocal_plan  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.train import make_serve_step as jmake_serve_step  # noqa: E402
from _torch_lm import numpy_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import (ShardingPlan, get_config,  # noqa: E402
                                 local_plan)
from repro_torch.core.selection import NOT_CONVERGED  # noqa: E402
from repro_torch.launch import serve as launch  # noqa: E402
from repro_torch.models import attention, model, transformer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TOL = 4e-6   # logits' tolerance relative to their largest magnitude


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs its files in
    parallel processes (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_serve(jcfg, params, B, P, G):
    """``repro/launch/serve.py``'s loop on given weights, returning each
    step's greedy token, the smallest top-2 margin of its logits and their
    largest magnitude."""
    plan = jlocal_plan()
    rng = np.random.default_rng(0)
    serve = jax.jit(jmake_serve_step(jcfg, plan))
    cache = jmodel.init_cache(jcfg, B, max_seq=P + G, plan=plan,
                              dtype=jnp.float32)
    prompt = rng.integers(0, jcfg.vocab, (B, P)).astype(np.int32)
    tok = jnp.asarray(prompt[:, :1])
    toks, margins, scale = [], [], 1.0
    for t in range(P + G - 1):
        nxt = (jnp.asarray(prompt[:, t + 1:t + 2]) if t + 1 < P else None)
        tok_out, logits, cache = serve(params, cache, tok,
                                       jnp.asarray(t, jnp.int32))
        top2 = np.sort(np.asarray(logits[:, -1]), axis=-1)[:, -2:]
        scale = max(scale, float(np.abs(np.asarray(logits)).max()))
        margins.append(top2[:, 1] - top2[:, 0])
        toks.append(np.asarray(tok_out))
        tok = nxt if nxt is not None else tok_out
    return np.concatenate(toks, axis=1), np.min(margins), scale


def sorted_percentiles(lat):
    s = np.sort(np.asarray(lat))
    n = s.size
    return s[(n + 1) // 2 - 1], s[int(np.clip(np.ceil(0.99 * n), 1, n)) - 1]


def assert_percentiles(res, lat):
    p50, p99 = sorted_percentiles(lat)
    assert int(res.p50.status) != NOT_CONVERGED
    assert int(res.p99.status) != NOT_CONVERGED
    assert res.p50.value.item() == p50 and res.p99.value.item() == p99


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "gemma2-2b"])
def test_serve_tokens_match_reference_launcher(arch):
    B, P, G = 4, 16, 16
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    tree = numpy_params(jcfg, seed=5)
    want, margin, scale = reference_serve(
        jcfg, jax.tree.map(jnp.asarray, tree), B, P, G)
    assert margin > 2 * TOL * scale
    res = launch.serve(cfg, B, P, G, device="cpu",
                       params=convert.params_from_numpy(tree, cfg, "cpu"))
    assert res.tokens.dtype == torch.int32
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.latencies.shape == (P + G - 3,)
    assert_percentiles(res, res.latencies.numpy())
    lat = jnp.asarray(res.latencies.numpy())
    for got, want in ((res.p50, jsel.median(lat)),
                      (res.p99, jsel.quantile(lat, 0.99))):
        for field in got._fields:
            assert getattr(got, field).item() == \
                np.asarray(getattr(want, field)).item(), field
    assert int(res.p50.iters) == int(res.p99.iters) == 0


@pytest.mark.parametrize("n", [1, 2, 29, 30, 100, 1001])
def test_latency_percentiles_equal_sorted_values(n):
    rng = np.random.default_rng(n)
    lat = (1e-3 * rng.lognormal(size=n)).astype(np.float32)
    lat[:: 7] = lat[0]  # ties
    p50, p99 = launch.latency_percentiles(torch.from_numpy(lat))
    res = SimpleNamespace(p50=p50, p99=p99)
    assert_percentiles(res, lat)


def test_entry_points_need_the_card_or_cpu_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen3-32b").reduced()
    tree = numpy_params(jget_config("qwen3-32b").reduced(), seed=1)
    for call in (lambda: model.init(0, cfg),
                 lambda: model.init_cache(cfg, 2, 8, local_plan()),
                 lambda: convert.params_from_numpy(tree, cfg),
                 lambda: launch.serve(cfg, 2, 2, 2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    params = model.init(0, cfg, device="cpu")
    cache = model.init_cache(cfg, 2, 8, local_plan(), device="cpu")
    assert params.embed.embedding.device.type == "cpu"
    assert cache[0]["k"].device.type == "cpu"
    assert cache[0]["k"].dtype == torch.bfloat16  # the reference's default
    res = launch.serve(cfg, 2, 3, 2, device="cpu")
    assert res.tokens.shape == (2, 4)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "kimi-k2-1t-a32b",
                                  "rwkv6-1.6b", "recurrentgemma-9b",
                                  "whisper-medium"])
def test_unported_families_raise(arch, monkeypatch):
    cfg = get_config(arch).reduced()

    def ran(*args, **kw):
        raise AssertionError("a decoder path ran for an unported family")

    for name in ("init_decoder", "init_cache", "forward", "decode_step",
                 "_layer_apply", "_layer_init"):
        monkeypatch.setattr(transformer, name, ran)
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    for call in (lambda: model.init(0, cfg, device="cpu"),
                 lambda: model.init_cache(cfg, 1, 4, local_plan(),
                                          device="cpu"),
                 lambda: model.forward(None, {"tokens": tokens}, cfg,
                                       local_plan()),
                 lambda: model.decode_step(None, [], tokens[:, :1], 0, cfg,
                                           local_plan()),
                 lambda: launch.serve(cfg, 1, 2, 2, device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
            call()


def test_a_plan_with_a_mesh_raises():
    mesh = SimpleNamespace(shape=(2, 4), mesh_dim_names=("data", "model"))
    plan = ShardingPlan(mesh=mesh, dp_axes=("data",), tp_axis="model",
                        seq_axes=("data",))
    assert (plan.tp, plan.dp, local_plan().tp, local_plan().dp) == (4, 2, 1, 1)
    cfg = get_config("gemma2-2b").reduced()
    with pytest.raises(NotImplementedError, match="11f"):
        model.init_cache(cfg, 1, 4, plan, device="cpu")
    with pytest.raises(NotImplementedError, match="11f"):
        plan.shard(torch.zeros(2))
    x = torch.zeros(2)
    assert local_plan().shard(x) is x


def test_repeat_kv_is_jnp_repeat():
    """GQA heads group as h = e*G + g: replication up to the TP degree is
    repeat_interleave (``jnp.repeat``), not tiling."""
    cfg = get_config("recurrentgemma-9b").reduced(n_kv_heads=1)
    mesh = SimpleNamespace(shape=(4,), mesh_dim_names=("model",))
    plan = ShardingPlan(mesh=mesh, tp_axis="model")
    assert attention.attn_tp(cfg, plan) == 4 and \
        attention.eff_kv(cfg, plan) == 4
    cfg = get_config("gemma2-2b").reduced()  # 2 kv heads
    assert attention.eff_kv(cfg, plan) == 4
    k = np.random.default_rng(0).standard_normal((1, 3, 2, 4)) \
        .astype(np.float32)
    got, _ = attention._repeat_kv(torch.from_numpy(k), torch.from_numpy(k),
                                  cfg, plan)
    np.testing.assert_array_equal(got.numpy(), np.repeat(k, 2, axis=2))


def test_launcher_cli_and_example_on_cpu(capsys, monkeypatch):
    launch.main(["--arch", "gemma2-2b", "--batch", "2", "--prompt-len", "4",
                 "--gen", "3", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=gemma2-2b (reduced) B=2: served 7 positions"
    assert out[1].startswith("latency p50=")
    monkeypatch.setattr(sys, "argv", [
        "serve_lm_torch.py", "--batch", "2", "--prompt-len", "5", "--gen",
        "4", "--device", "cpu"])
    runpy.run_path(str(ROOT / "examples" / "serve_lm_torch.py"),
                   run_name="__main__")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "arch=phi3-mini-3.8b (reduced): generated (2, 4) tokens"
    assert out[-1].startswith("per-token latency: p50=")


FRESH_INTERPRETER = """
import sys
sys.modules["jax"] = None
from repro_torch.convert import from_numpy, params_from_numpy
upper = [m for m in sys.modules if m.startswith(("repro_torch.models",
                                                 "repro_torch.configs"))]
print("convert loads:", upper)
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.analysis import param_counts
res = serve.serve(get_config("gemma3-27b").reduced(), 2, 3, 3, device="cpu")
print("served:", tuple(res.tokens.shape))
loaded = [m for m in sys.modules if m == "repro" or m.startswith("repro.")]
print("reference modules:", loaded)
"""


@pytest.fixture(scope="module")
def fresh_interpreter():
    """One fresh interpreter where ``import jax`` fails: it imports
    ``repro_torch.convert`` first, then serves a reduced model on the CPU;
    its printed lines, by the words before their colon."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable, "-c", FRESH_INTERPRETER], env=env,
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    return dict(line.split(": ", 1) for line in out.stdout.splitlines())


def test_serving_runs_with_jax_blocked(fresh_interpreter):
    """In a fresh interpreter where ``import jax`` fails, the port serves a
    reduced model on the CPU and no ``repro`` module loads."""
    assert fresh_interpreter["served"] == "(2, 5)"
    assert fresh_interpreter["reference modules"] == "[]"


def test_convert_loads_no_model_layer(fresh_interpreter):
    """``from repro_torch.convert import from_numpy, params_from_numpy`` in
    a fresh interpreter loads neither ``repro_torch.models`` nor
    ``repro_torch.configs``; the model layer comes in when
    ``params_from_numpy`` is called."""
    assert fresh_interpreter["convert loads"] == "[]"
