"""The port's training path held against the JAX reference on the CPU.

Reduced phi3-mini (untied, 2 units of 1 layer) and reduced gemma2-2b (tied,
local layers with window 8, softcaps, 2 units of 2 layers): weights made
with numpy from a seed go into the reference as a pytree and into the port
through ``convert.params_from_numpy``; batches come from
``data.batch_for_shape``, which gives the reference's numbers bit for bit.

* the decode cache's contract: a cache decodes each position once, in
  order; a ``copy_cache`` taken after position 4 decodes position 5 again
  to the reference's logits from its cache after step 4;
* ``lm_loss_fused``: loss, ``nll`` and ``zloss``, chunked and padded;
* the loss and every gradient leaf against ``jax.grad`` (phi3-mini;
  gemma2's in tests/test_torch_train_loop.py); remat gives the same bits
  as no remat;
* the quantile clips on the reference's own gradients;
* one and three train steps (reduced phi3-mini) for each clip
  (``quantile``, ``quantile_hist``, ``global_norm``, ``none``) and
  ``accum_steps=2``: metrics, ``clip_thr`` and the updated parameters,
  against the reference's step composed from its own jitted parts (its
  loss gradient, clip and ``AdamW.update``) in ``make_train_step``'s
  order: one gradient compile a config instead of one whole-step compile
  a clip keeps the file inside its time.

``batch_for_shape``, ``lm_loss`` and the optimizers from the reference's
state are in tests/test_torch_train_loop.py.

Tolerances (stated where used): the loss within ``LOSS_RTOL`` = 1e-5
relative; a gradient leaf within ``GRAD_TOL`` = 1e-4 of its max |g|
(observed < 1e-6); the quantile clip's threshold within ``THR_RTOL`` =
1e-3 relative (12 cutting-plane passes end on a bracket midpoint that
follows the last bits of the f32 sums: observed ~1e-4 between the two
clips on the same gradients; the reference's whole step under one ``jit``
moves its own threshold by 1.8e-3 against these parts, so a whole-step
compile would need the looser ``1e-3 * max(1, |thr|)`` of
tests/test_torch_robust_clip.py).  Updated parameters after ``n`` Adam
steps: every element within ``0.05 * lr * n`` of the reference's and all
but 2% within ``1e-4 * lr``: Adam's step ``m / (sqrt(v) + eps)`` turns the
last-bit differences of gradients near ``eps`` into visible ones
(observed: at most 0.03 lr, 0.8% of the elements beyond 1e-4 lr after 3
steps).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import local_plan as jlocal_plan  # noqa: E402
from repro.configs.base import ShapeConfig as JShapeConfig  # noqa: E402
from repro.core import robust as jrobust  # noqa: E402
from repro.data.pipeline import batch_for_shape as jbatch  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.train.step import _loss_from_batch as jloss_from_batch  # noqa: E402
from _torch_lm import numpy_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import get_config, local_plan  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data import batch_for_shape  # noqa: E402
from repro_torch.models import model  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.train import TrainState, make_train_step  # noqa: E402
from repro_torch.train.step import clip_grads, loss_and_grads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs its files in
    parallel processes (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHES = ("phi3-mini-3.8b", "gemma2-2b")
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
LR = 1e-2
B, S = 2, 24   # S - 1 = 23 predicted tokens: two KV chunks of 16, padded
THR_RTOL = 1e-3
SHAPE = ShapeConfig("train_test", seq_len=S, global_batch=B, kind="train")
JSHAPE = JShapeConfig("train_test", seq_len=S, global_batch=B, kind="train")


def rel(got, want):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


class Case:
    """One config's weights on both sides, its batches and the jitted
    reference loss-and-gradient call."""

    def __init__(self, arch):
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        assert self.cfg.n_units >= 2
        self.tree = numpy_params(self.jcfg, seed=ARCHES.index(arch) + 40)
        self.jparams = jax.tree.map(jnp.asarray, self.tree)
        jcfg, jplan = self.jcfg, jlocal_plan()
        self.jgrad = jax.jit(jax.value_and_grad(
            lambda p, b: jloss_from_batch(p, b, jcfg, jplan, "scan"),
            has_aux=True))

    def params(self, tree=None):
        return convert.params_from_numpy(self.tree if tree is None else tree,
                                         self.cfg, device="cpu")

    def batch(self, step, b=None):
        return batch_for_shape(self.cfg, SHAPE, seed=3, step=step,
                               batch_override=b)

    def jbatch(self, step):
        return {k: jnp.asarray(v) for k, v in jbatch(
            self.jcfg, JSHAPE, seed=3, step=step).items()}


@functools.cache
def case(arch) -> Case:
    return Case(arch)


def tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the decode cache's contract
# ---------------------------------------------------------------------------


def test_copied_cache_rewinds_to_the_reference_logits():
    """Reduced gemma2 (ring caches of window 8, global caches): decode
    positions 0-4, copy the cache, decode 5-11 on the original, then 5 on
    the copy: its logits equal the reference's from its cache after step 4
    (4e-6 of their largest magnitude, as tests/test_torch_models.py holds
    decode logits).  Position 5 on the original raises, and no ring slot of
    the copy holds a position past 5."""
    c = case("gemma2-2b")
    cfg, plan, jplan = c.cfg, local_plan(), jlocal_plan()
    params = c.params()
    toks = np.random.default_rng(21).integers(0, cfg.vocab, (2, 12)) \
        .astype(np.int32)
    jdecode = jax.jit(lambda p, ch, t, i: jmodel.decode_step(
        p, ch, t, i, c.jcfg, jplan))
    jcache = jmodel.init_cache(c.jcfg, 2, max_seq=12, plan=jplan,
                               dtype=jnp.float32)
    cache = model.init_cache(cfg, 2, 12, plan, dtype=torch.float32,
                             device="cpu")
    assert cache.next_pos == 0
    with torch.inference_mode():
        for t in range(5):
            _, jcache = jdecode(c.jparams, jcache,
                                jnp.asarray(toks[:, t:t + 1]),
                                jnp.asarray(t, jnp.int32))
            model.decode_step(params, cache, torch.from_numpy(
                toks[:, t:t + 1]), t, cfg, plan)
        saved = model.copy_cache(cache)
        assert saved.next_pos == cache.next_pos == 5
        for t in range(5, 12):
            model.decode_step(params, cache, torch.from_numpy(
                toks[:, t:t + 1]), t, cfg, plan)
        with pytest.raises(ValueError, match="copy_cache"):
            model.decode_step(params, cache, torch.from_numpy(toks[:, 5:6]),
                              5, cfg, plan)
        got, _ = model.decode_step(params, saved,
                                   torch.from_numpy(toks[:, 5:6]), 5, cfg,
                                   plan)
    want, _ = jdecode(c.jparams, jcache, jnp.asarray(toks[:, 5:6]),
                      jnp.asarray(5, jnp.int32))
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got.numpy() - want).max()) <= 4e-6 * scale
    assert saved.next_pos == 6 and cache.next_pos == 12
    for layer, kind in zip(saved, cfg.unit * cfg.n_units):
        if kind == "local":
            assert int(layer["pos"].max()) == 5
    with pytest.raises(ValueError, match="next position is 6"):
        model.decode_step(params, saved, torch.from_numpy(toks[:, 7:8]), 7,
                          cfg, plan)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def assert_loss(got, want, what):
    (loss, m), (jloss, jm) = got, want
    assert rel(loss, jloss) <= LOSS_RTOL, what
    for k in ("nll", "zloss"):
        assert rel(m[k], jm[k]) <= LOSS_RTOL, (what, k)


@pytest.mark.parametrize("arch", ARCHES)
@pytest.mark.parametrize("chunk", [8, 512])
def test_lm_loss_fused_matches_reference(arch, chunk):
    """Chunks of 8 over 23 positions (the last one padded) and one chunk;
    phi3's untied unembed, gemma2's tied embedding and final softcap."""
    c = case(arch)
    rng = np.random.default_rng(chunk)
    hidden = rng.standard_normal((2, 23, c.cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, c.cfg.vocab, (2, 23)).astype(np.int32)
    mask = np.ones((2, 23), np.int32)
    mask[1, 17:] = 0
    want = jmodel.lm_loss_fused(
        jnp.asarray(hidden), c.jparams["embed"], jnp.asarray(labels),
        jnp.asarray(mask), c.jcfg, jlocal_plan(), chunk=chunk)
    got = model.lm_loss_fused(
        torch.from_numpy(hidden), c.params().embed, torch.from_numpy(labels),
        torch.from_numpy(mask), c.cfg, local_plan(), chunk=chunk)
    assert_loss(got, want, f"{arch} lm_loss_fused chunk {chunk}")


@functools.cache
def grads_at(arch, step):
    """Both sides' (loss, metrics, grads) of the initial weights on the
    batch of ``step``; the reference's grads as ``{port name: array}``."""
    c = case(arch)
    (jloss, jm), jg = c.jgrad(c.jparams, c.jbatch(step))
    loss, m, g = loss_and_grads(c.params(), tbatch(c.batch(step)), c.cfg,
                                local_plan())
    return (loss, m, g), (jloss, jm, convert.named_from_numpy(to_np(jg),
                                                              c.cfg))


def test_loss_and_every_gradient_match_reference():
    """Reduced phi3-mini; gemma2-2b's are in
    tests/test_torch_train_loop.py."""
    (loss, m, g), (jloss, jm, jg) = grads_at("phi3-mini-3.8b", 0)
    assert_loss((loss, m), (jloss, jm), "phi3-mini-3.8b")
    assert sorted(g) == sorted(jg)
    for name, want in jg.items():
        err = float(np.abs(g[name].numpy() - want).max())
        assert err <= GRAD_TOL * float(np.abs(want).max()), (name, err)


@pytest.mark.parametrize("arch", ARCHES)
def test_remat_gives_the_same_bits(arch):
    """``remat='full'`` (each layer and each flash chunk recomputed in
    backward) changes no bit of the loss or the gradients."""
    c = case(arch)
    cfg = c.cfg
    full = dataclasses.replace(cfg, remat="full")
    batch = tbatch(c.batch(0))
    a = loss_and_grads(c.params(), batch, cfg, local_plan())
    b = loss_and_grads(c.params(), batch, full, local_plan())
    assert torch.equal(a[0], b[0])
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name


def test_the_quantile_clips_on_the_reference_gradients():
    """On the reference's gradients the port's quantile clip and the
    reference's (12 cutting-plane passes) agree within ``THR_RTOL``; the
    histogram clips within one of their 512 log-spaced bins."""
    c = case("phi3-mini-3.8b")
    (_, _, g), (_, _, jg) = grads_at("phi3-mini-3.8b", 0)
    _, jgrads = c.jgrad(c.jparams, c.jbatch(0))
    port = {n: torch.from_numpy(v.copy()) for n, v in jg.items()}
    _, thr = clip_grads(port, "quantile", 0.99, 12)
    want = ref_clip("phi3-mini-3.8b", "quantile")(jgrads)[1]
    assert rel(thr["clip_thr"], want["clip_thr"]) <= THR_RTOL
    _, thr = clip_grads(g, "quantile_hist", 0.99)
    hj = float(ref_clip("phi3-mini-3.8b", "quantile_hist")(
        jgrads)[1]["clip_thr"])
    flat = np.abs(np.concatenate([v.ravel() for v in jg.values()]))
    lo, hi = max(flat.min(), 1e-12), flat.max()
    ratio = np.exp((np.log(hi) - np.log(lo)) / 511)
    assert hj / ratio * (1 - 1e-6) <= float(thr["clip_thr"]) \
        <= hj * ratio * (1 + 1e-6)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------


STEP_CASES = [(clip, 1) for clip in
              ("quantile", "quantile_hist", "global_norm", "none")] + [
    ("quantile", 2)]


@functools.cache
def ref_clip(arch, clip):
    """The clip branch of the reference's ``make_train_step`` (its own
    ``robust.clip_by_quantile`` / ``hist_quantile``, in the step's words),
    jitted once per config and clip: grads -> (grads, metrics)."""

    def clip_fn(grads):
        if clip == "quantile":
            grads, thr = jrobust.clip_by_quantile(grads, 0.99, maxit=12)
            return grads, {"clip_thr": thr}
        if clip == "quantile_hist":
            thr = jnp.maximum(jrobust.hist_quantile(grads, 0.99), 1e-8)
            grads = jax.tree.map(
                lambda g: jnp.clip(g, -thr.astype(g.dtype),
                                   thr.astype(g.dtype)), grads)
            return grads, {"clip_thr": thr}
        if clip == "global_norm":
            gn = jnp.sqrt(sum(
                jnp.sum(jnp.square(g.astype(jnp.float32)))
                for g in jax.tree.leaves(grads)))
            scale = jnp.minimum(1.0, 1.0 / jnp.maximum(gn, 1e-9))
            grads = jax.tree.map(lambda g: g * scale.astype(g.dtype), grads)
            return grads, {"grad_norm": gn}
        return grads, {}

    return jax.jit(clip_fn)


@functools.cache
def ref_adamw(arch):
    return jax.jit(JAdamW(lr=LR).update)


def ref_step(c, arch, clip, accum, params, opt, batch):
    """One step of the reference's ``make_train_step`` (:90-133) from its
    own parts: the jitted loss gradient (``accum_steps`` microbatches
    summed in f32 in order from zeros and scaled, as its scan does), then
    :func:`ref_clip` and ``AdamW.update``, each jitted apart."""
    if accum == 1:
        (loss, metrics), grads = c.jgrad(params, batch)
    else:
        mb = batch["tokens"].shape[0] // accum
        zero = jnp.zeros((), jnp.float32)
        loss, metrics = zero, {"nll": zero, "zloss": zero}
        grads = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                             params)
        for i in range(accum):
            (l, m), g = c.jgrad(params, {k: v[i * mb:(i + 1) * mb]
                                         for k, v in batch.items()})
            grads = jax.tree.map(lambda a, b: a + b.astype(jnp.float32),
                                 grads, g)
            metrics = jax.tree.map(lambda a, b: a + b, metrics, m)
            loss = loss + l
        inv = 1.0 / accum
        grads = jax.tree.map(lambda g: g * inv, grads)
        metrics = jax.tree.map(lambda v: v * inv, metrics)
        loss = loss * inv
    grads, extra = ref_clip(arch, clip)(grads)
    params, opt = ref_adamw(arch)(grads, opt, params)
    return params, opt, dict(metrics, **extra, loss=loss)


@functools.cache
def train_run(arch, clip, accum):
    """Three steps on both sides from the same weights and batches (with
    ``accum_steps = 2`` a batch of 2 * B, so every microbatch has the
    shape of the jitted gradient); each side's metrics and parameters
    after steps 1 and 3."""
    c = case(arch)
    opt = AdamW(lr=LR)
    step = make_train_step(c.cfg, local_plan(), opt, clip=clip,
                           accum_steps=accum)
    jparams, jopt = c.jparams, JAdamW(lr=LR).init(c.jparams)
    params = c.params()
    state = TrainState(params=params, opt=opt.init(params), step=0)
    out = {}
    for i in range(3):
        batch = c.batch(i, B * accum)
        jparams, jopt, jm = ref_step(c, arch, clip, accum, jparams, jopt,
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        state, m = step(state, batch)
        if i in (0, 2):
            out[i + 1] = (
                {k: float(v) for k, v in m.items()},
                {k: float(v) for k, v in jm.items()},
                {n: p.detach().clone().numpy()
                 for n, p in state.params.named_parameters()},
                convert.named_from_numpy(to_np(jparams), c.cfg))
    assert state.step == 3 and int(state.opt["count"]) == 3
    return out


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("clip,accum", STEP_CASES)
def test_train_steps_match_reference(clip, accum, steps):
    """Reduced phi3-mini (the loss and gradients of both configs are held
    above; the clip and the optimizer do not depend on the model)."""
    m, jm, params, jparams = train_run("phi3-mini-3.8b", clip, accum)[steps]
    assert sorted(m) == sorted(jm)
    for k in ("loss", "nll", "zloss"):
        assert rel(m[k], jm[k]) <= LOSS_RTOL, k
    if clip == "global_norm":
        assert rel(m["grad_norm"], jm["grad_norm"]) <= LOSS_RTOL
    if clip.startswith("quantile"):
        assert rel(m["clip_thr"], jm["clip_thr"]) <= THR_RTOL
    far, total = 0, 0
    for name, want in jparams.items():
        d = np.abs(params[name] - want)
        assert float(d.max()) <= 0.05 * LR * steps, name
        far += int((d > 1e-4 * LR).sum())
        total += d.size
    assert far <= 0.02 * total, (far, total)
