"""The port's training loop and its parts on the CPU (the JAX reference
where there is one to hold them against).

* ``data.batch_for_shape`` equals the reference's bit for bit, and
  ``SyntheticPipeline`` streams, seeks and closes;
* ``lm_loss`` against the reference's; reduced gemma2's training loss and
  every gradient leaf against ``jax.grad`` (within 1e-4 of the leaf's max
  |g|; phi3-mini's are in tests/test_torch_train.py);
* AdamW and Adafactor from the reference's state after a step
  (``convert.opt_state_from_numpy``) on seeded gradients: one more update
  against the reference's, the in-place twins bit for bit, Adafactor's
  stacked grouping (and what it avoids), and the ``rem_i`` layers'
  mapping;
* ``int8_decompress`` bit for bit against the reference's, and
  ``int8_compress``'s contract;
* ``CheckpointManager``: atomic publish, retention, restore with shape and
  dtype checks;
* ``fit``: checkpoints, restart, a retry after an injected failure or a
  non-finite loss, the resumed run equal to an uninterrupted one, its
  step-time percentiles;
* ``launch/train.py`` and ``examples/train_lm_torch.py`` on their printed
  lines.

Optimizer states are held within ``1e-6`` of each leaf's largest magnitude
(a few f32 ulps: the same inputs through the same elementwise arithmetic);
a loss within ``1e-5`` relative.
"""
import functools
import math
import os
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import local_plan as jlocal_plan  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.data.pipeline import batch_for_shape as jbatch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import Adafactor as JAdafactor  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import int8_decompress as jint8_decompress  # noqa: E402
from repro.train.step import _loss_from_batch as jloss_from_batch  # noqa: E402
from _torch_lm import numpy_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, local_plan  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import SyntheticPipeline, batch_for_shape  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import (Adafactor, AdamW, int8_compress,  # noqa: E402
                               int8_decompress)
from repro_torch.train import TrainState, fit, make_train_step  # noqa: E402
from repro_torch.train.step import loss_and_grads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs its files in
    parallel processes (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHES = ("phi3-mini-3.8b", "gemma2-2b")
SHAPE = ShapeConfig("train_test", seq_len=24, global_batch=2, kind="train")
JSHAPE = JShapeConfig("train_test", seq_len=24, global_batch=2, kind="train")
STATE_RTOL = 1e-6


def rel(got, want):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


class Case:
    """One reduced config's weights on both sides."""

    def __init__(self, arch):
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        assert self.cfg.n_units >= 2
        self.tree = numpy_params(self.jcfg, seed=len(arch) + 50)
        self.jparams = jax.tree.map(jnp.asarray, self.tree)

    def params(self, tree=None):
        return convert.params_from_numpy(self.tree if tree is None else tree,
                                         self.cfg, device="cpu")


@functools.cache
def case(arch) -> Case:
    return Case(arch)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "llava-next-mistral-7b",
                                  "whisper-medium"])
@pytest.mark.parametrize("step", [0, 7])
def test_batch_for_shape_equals_reference(arch, step):
    """Token batches, llava's patch embeddings, whisper's audio frames."""
    cfg, jcfg = get_config(arch).reduced(), jget_config(arch).reduced()
    got = batch_for_shape(cfg, SHAPE, seed=5, step=step, batch_override=3)
    want = jbatch(jcfg, JSHAPE, seed=5, step=step, batch_override=3)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def test_pipeline_streams_seeks_and_closes():
    cfg = get_config("phi3-mini-3.8b").reduced()
    pipe = SyntheticPipeline(cfg, SHAPE, seed=9, start_step=2)
    try:
        for step in (2, 3, 4):
            np.testing.assert_array_equal(
                next(pipe)["tokens"],
                batch_for_shape(cfg, SHAPE, seed=9, step=step)["tokens"])
        assert pipe.state() == {"step": 5, "seed": 9}
        pipe.seek(1)
        assert pipe.state()["step"] == 1
        np.testing.assert_array_equal(
            next(pipe)["tokens"],
            batch_for_shape(cfg, SHAPE, seed=9, step=1)["tokens"])
    finally:
        pipe.close()
    assert pipe._thread is None


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cap", [0.0, 30.0])
def test_lm_loss_matches_reference(cap):
    rng = np.random.default_rng(int(cap) + 1)
    logits = (4 * rng.standard_normal((3, 10, 512))).astype(np.float32)
    labels = rng.integers(0, 512, (3, 10)).astype(np.int32)
    mask = (rng.random((3, 10)) < 0.8).astype(np.int32)
    want = jmodel.lm_loss(jnp.asarray(logits), jnp.asarray(labels),
                          jnp.asarray(mask), final_softcap=cap)
    got = model.lm_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                        torch.from_numpy(mask), final_softcap=cap)
    assert rel(got[0], want[0]) <= 1e-5
    for k in ("nll", "zloss"):
        assert rel(got[1][k], want[1][k]) <= 1e-5, k


def test_sharded_losses_and_steps_raise():
    """The vocab-sharded ``lm_loss``, ``lm_loss_fused`` on a mesh and the
    train step on a mesh wait for the sharded model (item 11f)."""
    from types import SimpleNamespace

    from repro_torch.configs import ShardingPlan
    mesh = SimpleNamespace(shape=(2, 4), mesh_dim_names=("data", "model"))
    plan = ShardingPlan(mesh=mesh, dp_axes=("data",), tp_axis="model")
    cfg = get_config("phi3-mini-3.8b").reduced()
    x = torch.zeros((1, 3, 8))
    labels = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="11f"):
        model.lm_loss(x, labels, labels, plan=plan)
    params = model.init(0, cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="11f"):
        model.lm_loss_fused(torch.zeros((1, 3, cfg.d_model)), params.embed,
                            labels, labels, cfg, plan)
    with pytest.raises(NotImplementedError, match="11f"):
        make_train_step(cfg, plan, AdamW())


def test_gemma2_loss_and_every_gradient_match_reference():
    """Tied embedding, local layers on the banded path, softcaps: the
    training loss (1e-5 relative) and every gradient leaf (within 1e-4 of
    its max |g|) against the reference's ``jax.value_and_grad``."""
    c = case("gemma2-2b")
    batch = batch_for_shape(c.cfg, SHAPE, seed=3, step=0)
    jcfg, jplan = c.jcfg, jlocal_plan()
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jloss_from_batch(p, b, jcfg, jplan, "scan"),
        has_aux=True))(c.jparams, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
    loss, m, g = loss_and_grads(c.params(), {
        k: torch.from_numpy(v) for k, v in batch.items()}, c.cfg,
        local_plan())
    assert rel(loss, jloss) <= 1e-5
    for k in ("nll", "zloss"):
        assert rel(m[k], jm[k]) <= 1e-5, k
    jg = convert.named_from_numpy(to_np(jg), c.cfg)
    assert sorted(g) == sorted(jg)
    for name, want in jg.items():
        err = float(np.abs(g[name].numpy() - want).max())
        assert err <= 1e-4 * float(np.abs(want).max()), (name, err)




# ---------------------------------------------------------------------------
# optimizers from the reference's state
# ---------------------------------------------------------------------------


def seeded_grads(c, seed):
    """Gradients shaped as the reference's parameter pytree: N(0, 1) at
    per-leaf scales 1e-4 .. 1, a tenth of each leaf exactly zero."""
    rng = np.random.default_rng(seed)

    def leaf(p):
        g = rng.standard_normal(p.shape).astype(np.float32)
        g *= np.float32(10.0 ** rng.uniform(-4, 0))
        g[rng.random(p.shape) < 0.1] = 0.0
        return jnp.asarray(g)

    return jax.tree.map(leaf, c.jparams)


def named(c, tree):
    return {n: torch.from_numpy(a.copy()) for n, a in
            convert.named_from_numpy(to_np(tree), c.cfg).items()}


def assert_close(got, want, what):
    """Each leaf within ``STATE_RTOL`` of its largest magnitude."""
    assert sorted(got) == sorted(want), what
    for name, w in want.items():
        g = got[name].detach().numpy()
        w = np.asarray(w)
        assert g.shape == w.shape, (what, name)
        err = float(np.abs(g - w).max())
        assert err <= STATE_RTOL * max(float(np.abs(w).max()), 1e-30), \
            (what, name, err)


@functools.cache
def jit_update(opt):
    return jax.jit(opt.update)


@pytest.mark.parametrize("arch", ARCHES)
def test_adamw_step_from_the_reference_state(arch):
    """The reference's params and state after one AdamW step, through
    ``params_from_numpy`` / ``opt_state_from_numpy``; the second step on
    the same gradients: params, m, v, master and count against the
    reference's; ``update_`` (in place) equals ``update`` bit for bit, and
    the new params never alias the master."""
    c = case(arch)
    jopt = JAdamW(lr=1e-2)
    g0, g1 = seeded_grads(c, 1), seeded_grads(c, 2)
    jp1, jo1 = jit_update(jopt)(g0, jopt.init(c.jparams), c.jparams)
    jp2, jo2 = jit_update(jopt)(g1, jo1, jp1)
    params = c.params(to_np(jp1))
    state = convert.opt_state_from_numpy(to_np(jo1), c.cfg, device="cpu")
    assert int(state["count"]) == 1
    opt = AdamW(lr=1e-2)
    grads = named(c, g1)
    new_p, new_state = opt.update(grads, state, params)
    assert int(new_state["count"]) == int(jo2["count"]) == 2
    assert_close(new_p, convert.named_from_numpy(to_np(jp2), c.cfg),
                 "params")
    for field in ("m", "v", "master"):
        assert_close(new_state[field], convert.named_from_numpy(
            to_np(jo2[field]), c.cfg), field)
    masters = {t.data_ptr() for t in new_state["master"].values()}
    assert not masters & {p.data_ptr() for p in new_p.values()}
    assert int(state["count"]) == 1  # update left its arguments alone
    opt.update_(grads, state, params)
    for n, p in params.named_parameters():
        assert torch.equal(p, new_p[n]), n
    for field in ("m", "v", "master"):
        for n, t in state[field].items():
            assert torch.equal(t, new_state[field][n]), (field, n)
    assert int(state["count"]) == 2


@pytest.mark.parametrize("arch", ARCHES)
def test_adafactor_step_from_the_reference_state(arch):
    """Adafactor on the reference's unit-stacked pytree and on the port's
    per-layer tensors grouped as the reference stacks them: the stats'
    shapes (a stacked norm scale (n_units, d) is factored: ``vr``
    (n_units,), ``vc`` (d,) shared by the units), then the second update
    from the reference's state, and its in-place twin."""
    c = case(arch)
    jopt, opt = JAdafactor(), Adafactor()
    g0, g1 = seeded_grads(c, 3), seeded_grads(c, 4)
    jp1, jo1 = jit_update(jopt)(g0, jopt.init(c.jparams), c.jparams)
    jp2, jo2 = jit_update(jopt)(g1, jo1, jp1)
    params = c.params(to_np(jp1))
    state = convert.opt_state_from_numpy(to_np(jo1), c.cfg, device="cpu")
    fresh = opt.init(params)
    assert sorted(fresh["stats"]) == sorted(state["stats"])
    for key, st in fresh["stats"].items():
        assert sorted(st) == sorted(state["stats"][key]), key
        for k, t in st.items():
            assert t.shape == state["stats"][key][k].shape, (key, k)
    d, n_units = c.cfg.d_model, c.cfg.n_units
    assert fresh["stats"]["units.0.ln1"]["vr"].shape == (n_units,)
    assert fresh["stats"]["units.0.ln1"]["vc"].shape == (d,)
    assert fresh["stats"]["final_norm"]["v"].shape == (d,)
    grads = named(c, g1)
    new_p, new_state = opt.update(grads, state, params)
    assert int(new_state["count"]) == int(jo2["count"]) == 2
    assert_close(new_p, convert.named_from_numpy(to_np(jp2), c.cfg),
                 "params")
    want = convert.opt_state_from_numpy(to_np(jo2), c.cfg, device="cpu")
    for key, st in want["stats"].items():
        assert_close(new_state["stats"][key], st, key)
    opt.update_(grads, state, params)
    for n, p in params.named_parameters():
        assert torch.equal(p, new_p[n]), n
    for key, st in new_state["stats"].items():
        for k, t in st.items():
            assert torch.equal(state["stats"][key][k], t), (key, k)


def test_adafactor_ungrouped_is_not_the_reference():
    """The trap the grouping avoids: the same per-layer tensors, each its
    own leaf, factor no norm scale and clip each layer's update alone, so
    the norm scales' update differs from the reference's."""
    c = case("phi3-mini-3.8b")
    jopt, opt = JAdafactor(), Adafactor()
    g = seeded_grads(c, 5)
    jp, _ = jit_update(jopt)(g, jopt.init(c.jparams), c.jparams)
    want = convert.named_from_numpy(to_np(jp), c.cfg)
    grads = named(c, g)
    grouped = c.params()
    got, _ = opt.update(grads, opt.init(grouped), grouped)
    assert_close(got, want, "grouped")
    alone = dict(c.params().named_parameters())
    loose, _ = opt.update(grads, opt.init(alone), alone)
    err = max(float(np.abs(loose[n].numpy() - want[n]).max())
              for n in want if n.endswith(("ln1", "ln2")))
    assert err > 1e-5


def test_remainder_layers_map_as_params_from_numpy():
    """Reduced gemma3 (a unit of 6 layers, 2 units, then 2 ``rem_i``
    layers, qk-norm): ``named_from_numpy`` gives every parameter's name and
    value as ``params_from_numpy`` places it, and the reference's
    Adafactor stats (filled with seeded draws) land on the port's groups
    with the port's shapes, a ``rem_i`` layer's leaves alone."""
    jcfg = jget_config("gemma3-27b").reduced()
    cfg = get_config("gemma3-27b").reduced()
    assert cfg.n_units == 2 and len(cfg.remainder) == 2
    tree = numpy_params(jcfg, seed=61)
    params = convert.params_from_numpy(tree, cfg, device="cpu")
    named_arrays = convert.named_from_numpy(tree, cfg)
    got = dict(params.named_parameters())
    assert sorted(named_arrays) == sorted(got)
    for n, a in named_arrays.items():
        np.testing.assert_array_equal(got[n].detach().numpy(), a)
    rng = np.random.default_rng(62)
    shapes = jax.eval_shape(JAdafactor().init, jax.tree.map(jnp.asarray,
                                                             tree))
    jstate = jax.tree.map(lambda s: rng.random(s.shape).astype(s.dtype),
                          shapes)
    state = convert.opt_state_from_numpy(jstate, cfg, device="cpu")
    fresh = Adafactor().init(params)
    assert sorted(state["stats"]) == sorted(fresh["stats"])
    for key, st in fresh["stats"].items():
        for k, t in st.items():
            assert state["stats"][key][k].shape == t.shape, (key, k)
    last = cfg.n_units * len(cfg.unit) + 1
    np.testing.assert_array_equal(
        state["stats"][f"layers.{last}.mixer.wq"]["vr"].numpy(),
        jstate["stats"]["rem_1"]["mixer"]["wq"]["vr"])
    np.testing.assert_array_equal(
        state["stats"]["units.5.ln2"]["vc"].numpy(),
        jstate["stats"]["units"][5]["ln2"]["vc"])


# ---------------------------------------------------------------------------
# int8 compression
# ---------------------------------------------------------------------------


def test_int8_decompress_equals_reference_bit_for_bit():
    c = case("gemma2-2b")
    params = c.params()
    groups = params.param_groups()
    grads = named(c, seeded_grads(c, 6))
    ctree, _ = int8_compress(torch.Generator().manual_seed(0), grads, groups)
    want = jint8_decompress({k: {"q": jnp.asarray(v["q"].numpy()),
                                 "scale": jnp.asarray(v["scale"].numpy())}
                             for k, v in ctree.items()})
    got = int8_decompress(ctree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      np.asarray(want[k]).view(np.int32))
    named_back = int8_decompress(ctree, groups)
    assert sorted(named_back) == sorted(grads)
    for n, g in named_back.items():
        assert g.shape == grads[n].shape


def test_int8_compress_contract():
    """Per leaf of the reference's grouping (one scale for a unit
    position's stacked layers): ``|q| <= 127``, the scale max|g| / 127,
    every dequantized value within one scale step of its input, the
    rounding unbiased on average, the generator's draws reproducible."""
    c = case("phi3-mini-3.8b")
    params = c.params()
    groups = params.param_groups()
    grads = named(c, seeded_grads(c, 7))
    gen = torch.Generator().manual_seed(11)
    ctree, gen_out = int8_compress(gen, grads, groups)
    assert gen_out is gen
    again, _ = int8_compress(torch.Generator().manual_seed(11), grads, groups)
    back = int8_decompress(ctree, groups)
    assert ctree["units.0.mixer.wq"]["q"].shape == (
        c.cfg.n_units,) + grads["layers.0.mixer.wq"].shape
    for key, (names, stacked) in groups.items():
        q, scale = ctree[key]["q"], ctree[key]["scale"]
        assert q.dtype == torch.int8 and int(q.abs().max()) <= 127
        assert torch.equal(q, again[key]["q"])
        gs = [grads[n] for n in names]
        amax = max(float(g.abs().max()) for g in gs)
        assert float(scale) == np.float32(max(amax, 1e-12)) / np.float32(127)
        for n in names:
            assert float((back[n] - grads[n]).abs().max()) <= \
                float(scale) * (1 + 1e-6)
    # unbiased: the mean error of a large leaf is far below a step
    big = "embed.embedding"
    err = (back[big] - grads[big]).double()
    step = float(ctree[big]["scale"])
    assert abs(float(err.mean())) <= 4 * step / math.sqrt(err.numel())


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def small_state(seed, dtype=torch.float32):
    cfg = get_config("phi3-mini-3.8b").reduced()
    params = model.init(seed, cfg, dtype=dtype, device="cpu")
    opt = AdamW()
    return TrainState(params=params, opt=opt.init(params), step=seed)


def test_checkpoint_round_trip_and_checks(tmp_path):
    src, dst = small_state(3), small_state(4)
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    ckpt.save(3, src, extra={"pipeline": {"step": 3, "seed": 0}})
    ckpt.wait()
    out, manifest = ckpt.restore(3, dst)
    assert manifest["step"] == 3 and manifest["extra"]["pipeline"]["step"] == 3
    assert out.step == 3 and out.params is dst.params
    for (n, a), (_, b) in zip(src.params.named_parameters(),
                              dst.params.named_parameters()):
        assert torch.equal(a, b), n
    for field in ("m", "v", "master"):
        for n, t in src.opt[field].items():
            assert torch.equal(t, dst.opt[field][n])
    assert "params/layers.0.mixer.wq" in manifest["keys"]
    assert "opt/m/layers.0.mixer.wq" in manifest["keys"]
    assert "opt/count" in manifest["keys"] and "step" in manifest["keys"]
    # shape, dtype and missing tensors refuse
    other = get_config("phi3-mini-3.8b").reduced(d_model=32)
    wrong = model.init(0, other, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(3, TrainState(wrong, AdamW().init(wrong), 0))
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(3, small_state(5, torch.bfloat16))
    short = small_state(6)
    short.opt.pop("master")
    short.opt["extra"] = torch.zeros(3)
    with pytest.raises(KeyError, match="opt/extra"):
        ckpt.restore(3, short)


def test_checkpoint_bf16_round_trip(tmp_path):
    src, dst = small_state(1, torch.bfloat16), small_state(2, torch.bfloat16)
    ckpt = CheckpointManager(str(tmp_path), async_save=False)
    ckpt.save(1, src)
    ckpt.restore(1, dst)
    for (n, a), (_, b) in zip(src.params.named_parameters(),
                              dst.params.named_parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n


def test_checkpoint_publish_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves no visible checkpoint (only a ``.tmp``),
    the earlier one stays the latest, and the error is raised from
    ``wait``."""
    state = small_state(1)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, state)
    ckpt.wait()

    def boom(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    ckpt.save(2, state)
    with pytest.raises(OSError, match="disk full"):
        ckpt.wait()
    assert ckpt.steps() == [1] and ckpt.latest_step() == 1
    assert sorted(os.listdir(tmp_path)) == ["step_00000001",
                                            "step_00000002.tmp"]


def test_checkpoint_retention(tmp_path):
    state = small_state(1)
    ckpt = CheckpointManager(str(tmp_path), keep=2, keep_every=4)
    for s in range(1, 10):
        ckpt.save(s, state)
    ckpt.wait()
    assert ckpt.steps() == [4, 8, 9]


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------

FIT_CFG = get_config("phi3-mini-3.8b").reduced()
FIT_SHAPE = ShapeConfig("fit", seq_len=16, global_batch=2, kind="train")


def fit_run(steps, *, ckpt=None, seed=0, wrap=None, log=None, **kw):
    params = model.init(seed, FIT_CFG, device="cpu")
    opt = AdamW(lr=1e-2)
    state = TrainState(params=params, opt=opt.init(params), step=0)
    step = make_train_step(FIT_CFG, local_plan(), opt, clip="quantile")
    pipe = SyntheticPipeline(FIT_CFG, FIT_SHAPE, seed=0)
    try:
        return fit(train_step=wrap(step) if wrap else step, state=state,
                   pipeline=pipe, steps=steps, ckpt=ckpt,
                   log_fn=(log.append if log is not None else lambda s: None),
                   **kw)
    finally:
        pipe.close()


@functools.cache
def uninterrupted():
    out = fit_run(8, log_every=4)
    return out["losses"], {n: p.detach().clone() for n, p in
                           out["state"].params.named_parameters()}, out


def same_params(state, want):
    return all(torch.equal(p, want[n])
               for n, p in state.params.named_parameters())


def test_fit_resumes_to_the_uninterrupted_run(tmp_path):
    """Stop after step 4 of 8 (checkpoints at 2 and 4), then a new process'
    worth of objects (other initial weights, a pipeline from step 0)
    resumes from step 4: its losses and final weights equal the
    uninterrupted run's bit for bit."""
    losses, final, _ = uninterrupted()
    ckpt = CheckpointManager(str(tmp_path), keep=3)
    first = fit_run(4, ckpt=ckpt, ckpt_every=2)
    assert first["losses"] == losses[:4]
    assert ckpt.steps() == [2, 4]
    log = []
    second = fit_run(8, ckpt=CheckpointManager(str(tmp_path), keep=3),
                     seed=1, ckpt_every=2, log=log)
    assert log[0] == "[loop] restored checkpoint step=4"
    assert second["losses"] == losses[4:]
    assert second["state"].step == 8 and same_params(second["state"], final)
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("fault", ["raise", "nan"])
def test_fit_retries_from_the_last_checkpoint(tmp_path, fault):
    """Step 5 fails once (an exception, or a non-finite loss after the
    update was applied): the loop restores step 4 and replays it, and ends
    on the uninterrupted run's weights; past ``max_retries`` it raises."""
    losses, final, _ = uninterrupted()
    calls = []

    def wrap(step):
        def faulty(state, batch):
            calls.append(state.step)
            if state.step == 5 and calls.count(5) == 1:
                if fault == "raise":
                    raise RuntimeError("device lost")
                state, m = step(state, batch)
                return state, dict(m, loss=torch.tensor(float("nan")))
            return step(state, batch)
        return faulty

    log = []
    out = fit_run(8, ckpt=CheckpointManager(str(tmp_path)), ckpt_every=2,
                  wrap=wrap, log=log)
    assert out["retries"] == 1
    assert any(line.startswith("[loop] step 5 failed") and
               line.endswith("restoring step 4") for line in log)
    assert calls == [0, 1, 2, 3, 4, 5, 4, 5, 6, 7]
    assert out["losses"] == losses[:5] + losses[4:]
    assert same_params(out["state"], final)

    def always(step):
        def broken(state, batch):
            raise RuntimeError("device lost")
        return broken

    with pytest.raises(RuntimeError, match="device lost"):
        fit_run(8, ckpt=CheckpointManager(str(tmp_path / "b")),
                wrap=always, max_retries=2)
    with pytest.raises(RuntimeError, match="device lost"):
        fit_run(8, wrap=always)  # no checkpoint: nothing to restore


def test_fit_logs_step_time_percentiles():
    """Every ``log_every`` steps: p50 and p99 of the step times by exact
    selection, equal to the sorted times' values."""
    _, _, out = uninterrupted()
    assert [p["step"] for p in out["percentiles"]] == [4, 8]
    times = np.asarray(out["times"], np.float32)
    srt = np.sort(times)
    n = len(times)
    assert out["percentiles"][-1]["p50"] == float(srt[(n + 1) // 2 - 1])
    assert out["percentiles"][-1]["p99"] == float(srt[math.ceil(0.99 * n) - 1])
    # 8 times fit the selection's cap: no cutting-plane pass, as the
    # reference's loop takes none on so few times
    assert [p["passes"] for p in out["percentiles"]] == [0, 0]


# ---------------------------------------------------------------------------
# launcher and example
# ---------------------------------------------------------------------------


def test_launcher_trains_on_the_cpu(capsys, tmp_path):
    launch.main(["--arch", "phi3-mini-3.8b", "--steps", "10", "--batch", "2",
                 "--seq", "16", "--device", "cpu", "--ckpt-dir",
                 str(tmp_path)])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("[step 10] loss=") and "p50=" in lines[0]
    assert lines[-1].startswith("done: loss ")
    first, last = map(float, lines[-1][len("done: loss "):].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)
    assert CheckpointManager(str(tmp_path)).steps() == [10]


def test_launcher_resumes_from_its_checkpoints(tmp_path):
    """``train()`` stopped after step 4 and called again to step 8 on the
    same directory: ``fit`` restores step 4 and moves the pipeline there,
    so steps 5-8 give the uninterrupted run's losses, bit for bit."""
    cfg = get_config("phi3-mini-3.8b").reduced()
    kw = dict(batch=2, seq=16, ckpt_every=2, log_every=10 ** 9,
              device="cpu", log_fn=lambda line: None)
    full = launch.train(cfg, steps=8, **kw)
    first = launch.train(cfg, steps=4, ckpt_dir=str(tmp_path), **kw)
    second = launch.train(cfg, steps=8, ckpt_dir=str(tmp_path), **kw)
    assert first["losses"] + second["losses"] == full["losses"]


def test_launcher_refuses_aot_and_needs_the_card_or_cpu(monkeypatch):
    with pytest.raises(NotImplementedError, match="11h"):
        launch.main(["--aot"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.opt_state_from_numpy({"count": np.int32(0)}, FIT_CFG)


def test_example_trains_on_the_cpu(capsys, monkeypatch, tmp_path):
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--steps", "2", "--batch", "2", "--seq", "16",
        "--device", "cpu", "--ckpt-dir", str(tmp_path)])
    runpy.run_path(str(ROOT / "examples" / "train_lm_torch.py"),
                   run_name="__main__")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("arch=gemma2-2b (reduced) params=")
    assert lines[0].endswith("batch=2 seq=16 clip=quantile")
    assert lines[-1].startswith("final loss: ")
    assert lines[-1].endswith("; retries=0")
