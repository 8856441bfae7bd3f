"""The port's dense decoders held against the JAX reference on the CPU.

For the five dense configs ``.reduced()`` (phi3-mini, gemma2, gemma3,
qwen3, llava-next), weights made with numpy from a seed go into the
reference as a pytree and into the port through
``convert.params_from_numpy``; the same numpy inputs go through both:

* ``forward(mode="prefill")`` logits on a prompt of 27 tokens, longer than
  ``attn_chunk`` = 16 (two KV chunks, the second padded) and than the
  window 8 (gemma2 / gemma3's local layers take the banded path, padded),
  llava with its 8 patch embeddings prepended;
* 6 ``decode_step``s at positions 3..8 (the ring cache of the local layers
  wraps at 8): logits at every step and every layer's cache after the last;
* the port's decode against its own prefill (the reference's
  ``test_decode_matches_forward``), 12 positions;
* ``param_counts`` at the reduced size and at full size (the port's model
  built on the ``meta`` device).

Tolerances: both sides compute in f32 with other summation orders, so
logits and caches are held to ``TOL`` = 4e-6 times the largest reference
magnitude (about 64 f32 ulps of it; the observed differences stay under
4e-7 of it).  One jitted reference call per config and kind of call.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis.params import param_counts as jparam_counts  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import local_plan as jlocal_plan  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from _torch_lm import numpy_params  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.analysis import param_counts  # noqa: E402
from repro_torch.configs import get_config, local_plan  # noqa: E402
from repro_torch.models import attention, model  # noqa: E402
from repro_torch.train import make_prefill_step, make_serve_step  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread per process: the suite runs its files in
    parallel processes (restored after the module)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


DENSE = ("phi3-mini-3.8b", "gemma2-2b", "gemma3-27b", "qwen3-32b",
         "llava-next-mistral-7b")
TOL = 4e-6
B, S_PROMPT = 2, 27
DECODE_FROM, DECODE_STEPS, MAX_SEQ = 3, 6, 12


def assert_close(got, want, what):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= TOL * scale, f"{what}: max error {err} > {TOL} * {scale}"


class Case:
    """One config's weights on both sides and its jitted reference calls."""

    def __init__(self, arch):
        self.jcfg = jget_config(arch).reduced()
        self.cfg = get_config(arch).reduced()
        self.tree = numpy_params(self.jcfg, seed=DENSE.index(arch))
        self.jparams = jax.tree.map(jnp.asarray, self.tree)
        self.params = convert.params_from_numpy(self.tree, self.cfg,
                                                device="cpu")
        jcfg, jplan = self.jcfg, jlocal_plan()
        self.jprefill = jax.jit(lambda p, b: jmodel.forward(
            p, b, jcfg, jplan, mode="prefill")[0])
        self.jdecode = jax.jit(lambda p, c, t, i: jmodel.decode_step(
            p, c, t, i, jcfg, jplan))


@functools.cache
def case(arch) -> Case:
    return Case(arch)


def prompt_batch(cfg, seed, n_tokens=S_PROMPT):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, n_tokens))
             .astype(np.int32)}
    if cfg.frontend == "patch_stub":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def reference_cache_layers(jcache, cfg):
    """The reference's cache ({'units': stacked, 'rem_i': ...}) as the
    port's list of per-layer dicts, in the order the layers run."""
    out = [{k: np.asarray(v)[u] for k, v in jcache["units"][i].items()}
           for u in range(cfg.n_units) for i in range(len(cfg.unit))]
    out += [{k: np.asarray(v) for k, v in jcache[f"rem_{i}"].items()}
            for i in range(len(cfg.remainder))]
    return out


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_logits_match_reference(arch, monkeypatch):
    c = case(arch)
    batch = prompt_batch(c.cfg, seed=10)
    want = c.jprefill(c.jparams, {k: jnp.asarray(v) for k, v in batch.items()})

    banded = []
    real = attention.banded_flash_attention
    monkeypatch.setattr(attention, "banded_flash_attention",
                        lambda *a, **kw: banded.append(1) or real(*a, **kw))
    got = make_prefill_step(c.cfg, local_plan())(
        c.params, {k: torch.from_numpy(v) for k, v in batch.items()})
    n_text = S_PROMPT + c.cfg.n_frontend_tokens
    assert got.shape == (B, n_text, c.cfg.vocab)
    assert_close(got.numpy(), want, f"{arch} prefill logits")
    assert len(banded) == c.cfg.unit.count("local") * c.cfg.n_units + \
        c.cfg.remainder.count("local")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch):
    c = case(arch)
    cfg = c.cfg
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab, (B, DECODE_STEPS)).astype(np.int32)
    jcache = jmodel.init_cache(c.jcfg, B, max_seq=MAX_SEQ, plan=jlocal_plan(),
                               dtype=jnp.float32)
    cache = model.init_cache(cfg, B, max_seq=MAX_SEQ, plan=local_plan(),
                             dtype=torch.float32, device="cpu")
    # the reference decodes from position 3 over the zero slots 0..2 of a
    # fresh cache; the port's cache decodes from its next position, set so
    cache.next_pos = DECODE_FROM
    step = make_serve_step(cfg, local_plan())
    for t in range(DECODE_STEPS):
        index = DECODE_FROM + t
        want, jcache = c.jdecode(c.jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                                 jnp.asarray(index, jnp.int32))
        nxt, got, cache = step(c.params, cache, torch.from_numpy(
            toks[:, t:t + 1]), index)
        assert got.shape == (B, 1, cfg.vocab)
        assert_close(got.numpy(), want, f"{arch} decode logits at {index}")
        np.testing.assert_array_equal(
            nxt.numpy()[:, 0], np.argmax(got.numpy()[:, -1], axis=-1))
    want_layers = reference_cache_layers(jcache, cfg)
    assert len(cache) == len(want_layers) == cfg.n_layers
    for j, (g, w) in enumerate(zip(cache, want_layers)):
        assert sorted(g) == sorted(w), j
        for key in w:
            if key == "pos":
                np.testing.assert_array_equal(g[key].numpy(), w[key])
            else:
                assert_close(g[key].numpy(), w[key], f"{arch} layer {j} {key}")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """Stepwise decode logits == the full-sequence prefill's, 12 positions
    (past the window 8: the ring cache wraps)."""
    c = case(arch)
    cfg = c.cfg
    T = 12
    toks = np.random.default_rng(12).integers(0, cfg.vocab, (B, T)) \
        .astype(np.int32)
    full = make_prefill_step(cfg, local_plan())(
        c.params, {"tokens": torch.from_numpy(toks)}).numpy()
    cache = model.init_cache(cfg, B, max_seq=T, plan=local_plan(),
                             dtype=torch.float32, device="cpu")
    step = make_serve_step(cfg, local_plan())
    outs = []
    for t in range(T):
        _, lg, cache = step(c.params, cache, torch.from_numpy(toks[:, t:t + 1]),
                            t)
        outs.append(lg[:, 0].numpy())
    assert_close(np.stack(outs, axis=1), full, f"{arch} decode vs prefill")


@pytest.mark.parametrize("arch", DENSE)
def test_param_counts_match_reference(arch):
    c = case(arch)
    want = jparam_counts(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), c.jcfg)), c.jcfg)
    assert param_counts(c.params, c.cfg) == want
    jfull, full = jget_config(arch), get_config(arch)
    want = jparam_counts(jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), jfull)), jfull)
    got = param_counts(model.init(0, full, device="meta"), full)
    assert got == want
    named = {"phi3-mini-3.8b": 3_821_079_552, "gemma2-2b": 2_614_222_080}
    if arch in named:
        assert got[0] == named[arch]


def test_params_keep_the_reference_layout():
    """Layer u * len(unit) + i of the port holds unit u, position i of the
    reference's stacked leaves; the remainder layers follow (gemma3: 2)."""
    c = case("gemma3-27b")
    cfg = c.cfg
    assert cfg.n_units == 2 and len(cfg.unit) == 6 and \
        cfg.remainder == ("local", "local")
    for u in range(cfg.n_units):
        for i, kind in enumerate(cfg.unit):
            block = c.params.layers[u * len(cfg.unit) + i]
            assert block.kind == kind
            np.testing.assert_array_equal(
                block.mixer.wq.detach().numpy(),
                c.tree["units"][i]["mixer"]["wq"][u])
            np.testing.assert_array_equal(
                block.mixer.k_norm.detach().numpy(),
                c.tree["units"][i]["mixer"]["k_norm"][u])
    for i in range(2):
        np.testing.assert_array_equal(
            c.params.layers[12 + i].ffn.w_out.detach().numpy(),
            c.tree[f"rem_{i}"]["ffn"]["w_out"])
    assert c.params.embed.unembed is None  # tied
