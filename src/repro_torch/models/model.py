"""Model dispatch and the LM losses, ported from ``repro.models.model``.

``init``, ``forward``, ``init_cache``, ``decode_step`` (and
``copy_cache``, see ``transformer.DecodeCache``) for the decoder family;
the encoder-decoder family (whisper) raises ``NotImplementedError``
(ROADMAP Queue 1 item 11e).  ``lm_loss`` and the fused chunked
``lm_loss_fused``; their sharded variants and the sharding rules
(``param_specs``, ``cache_specs``) come with the sharding slice (item
11f).

``init`` and ``init_cache`` allocate on ``device``, which defaults to the
card and raises when there is none: the CPU must be asked for by name.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import _device
from repro_torch.configs.base import (ENCDEC, SHARDING, ModelConfig,
                                      ShardingPlan, not_ported)
from repro_torch.models import transformer
from repro_torch.models.layers import softcap
from repro_torch.models.transformer import DecodeCache, copy_cache


def _check(cfg: ModelConfig, plan: ShardingPlan = None) -> None:
    """Raise, before anything runs, for what the port does not have yet."""
    if cfg.family == "encdec":
        raise not_ported(f"the encoder-decoder family ({cfg.name})", ENCDEC)
    transformer.check_ported(cfg, plan)


def init(key, cfg: ModelConfig, dtype=torch.float32,
         device=None) -> transformer.Decoder:
    """A decoder with weights drawn from ``key``: a ``torch.Generator`` on
    ``device`` (any generator for ``device="meta"``) or an int seed."""
    _check(cfg)
    device = _device.resolve(device, "model.init")
    if isinstance(key, torch.Generator):
        gen = key
    else:
        gen = torch.Generator(
            device="cpu" if device.type == "meta" else device)
        gen.manual_seed(int(key))
    return transformer.init_decoder(gen, cfg, dtype, device)


def forward(params, batch, cfg: ModelConfig, plan: ShardingPlan,
            mode="train", return_hidden=False):
    _check(cfg, plan)
    return transformer.forward(params, batch, cfg, plan, mode=mode,
                               return_hidden=return_hidden)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               plan: ShardingPlan, dtype=torch.bfloat16, enc_seq: int = 0,
               device=None):
    _check(cfg, plan)
    device = _device.resolve(device, "model.init_cache")
    return transformer.init_cache(cfg, batch, max_seq, plan, dtype, device)


def decode_step(params, cache: DecodeCache, token, index, cfg: ModelConfig,
                plan: ShardingPlan):
    """One-token decode at ``index``, the cache's next position (a
    ``ValueError`` otherwise); the cache is written in place."""
    _check(cfg, plan)
    return transformer.decode_step(params, cache, token, index, cfg, plan)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def lm_loss(logits, labels, mask, *, z_weight: float = 1e-4,
            plan: Optional[ShardingPlan] = None, final_softcap: float = 0.0):
    """Stable CE + z-loss. logits (B,S,V); labels/mask (B,S).  The final
    logit softcap (gemma2) applies here in f32: ``forward(mode='train')``
    emits raw logits.  Returns (loss, {'nll', 'zloss'})."""
    if plan is not None and plan.mesh is not None and plan.tp_axis:
        raise not_ported("the vocab-sharded lm_loss", SHARDING)
    lf = softcap(logits.float(), final_softcap)
    logz = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    m = mask.float()
    denom = torch.clamp(torch.sum(m), min=1.0)
    nll = torch.sum((logz - ll) * m) / denom
    zloss = torch.sum(logz * logz * m) / denom
    return nll + z_weight * zloss, {"nll": nll, "zloss": zloss}


def _chunk_terms(xc, W, lbc, mkc, tied: bool, cap: float):
    """One sequence chunk of the fused loss: its (B, c, V) f32 logits
    reduced to the sums of nll, logz^2 and the mask."""
    lf = softcap(xc @ W.T if tied else xc @ W, cap)
    # the max shift is gradient-neutral
    mx = torch.amax(lf.detach(), dim=-1)
    logz = mx + torch.log(torch.sum(torch.exp(lf - mx[..., None]), dim=-1))
    ll = torch.gather(lf, -1, lbc[..., None].long())[..., 0]
    m = mkc.float()
    return (torch.sum((logz - ll) * m), torch.sum(logz * logz * m),
            torch.sum(m))


def lm_loss_fused(hidden, embed_params, labels, mask, cfg: ModelConfig,
                  plan: ShardingPlan, *, z_weight: float = 1e-4,
                  chunk: int = 512):
    """Fused chunked unembed + CE: full logits are never materialized.

    ``hidden``: final normed hidden states (B, S, D); ``embed_params``: the
    decoder's ``embed`` (its ``embedding`` when tied, else its
    ``unembed``).  Each sequence chunk's (B, c, V) f32 logits are reduced
    to three sums and dropped; under autograd each chunk is recomputed in
    backward (``torch.utils.checkpoint``, where the reference uses
    ``jax.checkpoint``).  Returns (loss, {'nll', 'zloss'})."""
    if plan.mesh is not None:
        raise not_ported("lm_loss_fused on a DeviceMesh", SHARDING)
    tied = cfg.tie_embeddings
    W = embed_params.embedding if tied else embed_params.unembed
    b, s, _ = hidden.shape
    c = min(chunk, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    if pad:
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        mask = torch.nn.functional.pad(mask, (0, pad))
    remat = torch.is_grad_enabled()
    nll = zl = den = torch.zeros((), dtype=torch.float32,
                                 device=hidden.device)
    for i in range(n_chunks):
        args = (hidden[:, i * c:(i + 1) * c], W, labels[:, i * c:(i + 1) * c],
                mask[:, i * c:(i + 1) * c], tied, cfg.final_softcap)
        if remat:
            a, z, d = checkpoint(_chunk_terms, *args, use_reentrant=False)
        else:
            a, z, d = _chunk_terms(*args)
        nll, zl, den = nll + a, zl + z, den + d
    den = torch.clamp(den, min=1.0)
    nll, zl = nll / den, zl / den
    return nll + z_weight * zl, {"nll": nll, "zloss": zl}
