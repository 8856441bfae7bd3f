"""Step factories, ported from ``repro.train.step``: the train step (grad
+ robust clip + optimizer), the prefill step and the serve step (greedy
decode).

The paper's technique is a first-class training feature here:
``clip='quantile'`` clips gradient magnitudes at their global q-quantile
by the cutting-plane selector over the whole gradient tree
(``core.robust.clip_by_quantile``).  The steps run eagerly (the reference
jits them).  The sharding of the train state (``_zero1_spec``,
``train_state_specs``) comes with the sharded model (ROADMAP Queue 1 item
11f).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.configs.base import SHARDING, ModelConfig, ShardingPlan, \
    not_ported
from repro_torch.core import robust
from repro_torch.models import model
from repro_torch.models.transformer import Decoder

CLIPS = ("quantile", "quantile_hist", "global_norm", "none")


@dataclasses.dataclass
class TrainState:
    """The decoder, the optimizer's state and the step (a Python int)."""
    params: Decoder
    opt: Any
    step: int = 0


def _on_device(batch, device):
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _loss_from_batch(params: Decoder, batch, cfg: ModelConfig,
                     plan: ShardingPlan):
    """Fused-unembed chunked CE: full logits are never materialized."""
    hidden, aux = model.forward(params, batch, cfg, plan, mode="train",
                                return_hidden=True)
    tokens = batch["tokens"]
    if cfg.frontend == "patch_stub" and "patches" in batch:
        hidden = hidden[:, batch["patches"].shape[1]:]
    return model.lm_loss_fused(hidden[:, :-1], params.embed, tokens[:, 1:],
                               torch.ones_like(tokens[:, 1:]), cfg, plan)


def loss_and_grads(params: Decoder, batch, cfg: ModelConfig,
                   plan: ShardingPlan, accum_steps: int = 1):
    """(loss, metrics, grads ``{name: tensor}``) of one batch (tensors on
    the decoder's device).  ``accum_steps > 1`` splits the batch into that
    many microbatches along dim 0, one backward each; their grads are
    summed in f32 in microbatch order and scaled by ``1 / accum_steps``,
    the loss and metrics averaged, as the reference's scan does."""
    names, leaves = zip(*params.named_parameters())

    def grads_of(mb):
        with torch.enable_grad():
            loss, metrics = _loss_from_batch(params, mb, cfg, plan)
            grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    if accum_steps <= 1:
        return grads_of(batch)
    b = batch["tokens"].shape[0]
    if b % accum_steps:
        raise ValueError(f"batch {b} does not split into {accum_steps} "
                         f"microbatches")
    mb = b // accum_steps
    loss_a, metrics_a, g_a = None, None, None
    for i in range(accum_steps):
        loss, metrics, grads = grads_of(
            {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
        if g_a is None:  # the reference's carry starts at zeros
            zero = torch.zeros((), dtype=torch.float32, device=loss.device)
            loss_a, metrics_a = zero, {k: zero for k in metrics}
            g_a = {n: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device) for n, g in grads.items()}
        g_a = {n: g_a[n] + grads[n].to(torch.float32) for n in names}
        metrics_a = {k: metrics_a[k] + metrics[k] for k in metrics}
        loss_a = loss_a + loss
        del grads
    inv = 1.0 / accum_steps
    return (loss_a * inv, {k: v * inv for k, v in metrics_a.items()},
            {n: g * inv for n, g in g_a.items()})


def clip_grads(grads: Dict[str, torch.Tensor], clip: str = "quantile",
               clip_q: float = 0.99, clip_maxit: int = 12):
    """(clipped grads, metrics): ``'quantile'`` clips at the global
    q-quantile of |g| (``robust.clip_by_quantile``, metric ``clip_thr``),
    ``'quantile_hist'`` at the histogram estimate of it (floored at
    1e-8), ``'global_norm'`` scales to a global norm of at most 1 (metric
    ``grad_norm``), ``'none'`` leaves them."""
    if clip == "quantile":
        grads, thr = robust.clip_by_quantile(grads, clip_q, maxit=clip_maxit)
        return grads, {"clip_thr": thr}
    if clip == "quantile_hist":
        # 2-pass histogram variant: ~1.8% bin resolution, 2 gradient sweeps
        thr = torch.clamp(robust.hist_quantile(grads, clip_q), min=1e-8)
        return {n: torch.clamp(g, -thr.to(g.dtype), thr.to(g.dtype))
                for n, g in grads.items()}, {"clip_thr": thr}
    if clip == "global_norm":
        gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                            for g in grads.values()))
        scale = torch.clamp(1.0 / torch.clamp(gn, min=1e-9), max=1.0)
        return {n: g * scale.to(g.dtype) for n, g in grads.items()}, \
            {"grad_norm": gn}
    if clip != "none":
        raise ValueError(clip)
    return grads, {}


def make_train_step(cfg: ModelConfig, plan: ShardingPlan, optimizer, *,
                    clip: str = "quantile", clip_q: float = 0.99,
                    clip_maxit: int = 12, accum_steps: int = 1):
    """Returns ``train_step(state, batch) -> (state, metrics)``.

    ``batch`` holds numpy arrays (or tensors); the step moves them to the
    decoder's device.  The metrics are 0-d tensors: ``loss``, ``nll``,
    ``zloss`` and ``clip_thr`` or ``grad_norm``.  The optimizer's update
    is written into the decoder's parameters and the optimizer state in
    place (``optimizer.update_``, under ``torch.no_grad()``), so the
    returned state holds the same decoder and state objects, updated."""
    model._check(cfg, plan)
    if plan.mesh is not None:
        raise not_ported("the train step on a DeviceMesh", SHARDING)
    if clip not in CLIPS:
        raise ValueError(clip)

    def train_step(state: TrainState, batch):
        device = state.params.final_norm.device
        loss, metrics, grads = loss_and_grads(
            state.params, _on_device(batch, device), cfg, plan, accum_steps)
        grads, extra = clip_grads(grads, clip, clip_q, clip_maxit)
        optimizer.update_(grads, state.opt, state.params)
        del grads
        metrics = dict(metrics, **extra, loss=loss)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, plan: ShardingPlan):
    """(params, batch) -> logits (B, S, V), final softcap applied."""

    def prefill_step(params, batch):
        with torch.inference_mode():
            logits, _ = model.forward(params, batch, cfg, plan,
                                      mode="prefill")
        return logits

    return prefill_step


def make_serve_step(cfg: ModelConfig, plan: ShardingPlan):
    """One-token decode: (params, cache, token, index) -> (next_token,
    logits, cache) — greedy argmax (the first maximum) as int32.  The
    cache is written in place; ``index`` must be its next position."""

    def serve_step(params, cache, token, index):
        with torch.inference_mode():
            logits, new_cache = model.decode_step(params, cache, token,
                                                  index, cfg, plan)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, new_cache

    return serve_step
