"""Shared neural building blocks, ported from ``repro.models.layers``.

Parameters live in ``nn.Module`` containers (:class:`MLP`, :class:`Embed`)
whose attribute names are the reference's pytree keys; the math is plain
functions on tensors, one for each of the reference's.  Initializers draw
from an explicit ``torch.Generator`` with the reference's distributions
(not its bits: weights that must match cross through
``repro_torch.convert.params_from_numpy``).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig, ShardingPlan


def _init(gen, shape, scale=None, dtype=torch.float32, device=None):
    """N(0, 1) * scale drawn in f32, then cast; ``scale`` defaults to
    1/sqrt(shape[0]) for matrices (fan-in) and 1 for vectors."""
    if scale is None:
        scale = 1.0 / (shape[0] ** 0.5 if len(shape) > 1 else 1.0)
    x = torch.empty(shape, dtype=torch.float32, device=device)
    return x.normal_(generator=gen).mul_(scale).to(dtype)


def _zeros(shape, dtype, device):
    return torch.zeros(shape, dtype=dtype, device=device)


def rms_norm(x, scale, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


def softcap(x, cap: float):
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def rope(x, positions, theta: float):
    """Rotary embedding on split halves. x: (..., S, H, hd); positions:
    (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    ar = torch.arange(0, half, dtype=torch.float32, device=x.device)
    # a Python-scalar base: f32 math, and no host-to-device copy (which
    # would wait for the card on every layer)
    freq = torch.pow(theta, -ar / half)
    ang = positions[..., :, None].float() * freq  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]  # (..., S, 1, half)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def act_fn(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": functools.partial(F.gelu, approximate="tanh")}[name]


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


class MLP(nn.Module):
    """w_gate, w_in: (d_model, d_ff); w_out: (d_ff, d_model)."""

    def __init__(self, w_gate, w_in, w_out):
        super().__init__()
        self.w_gate = nn.Parameter(w_gate)
        self.w_in = nn.Parameter(w_in)
        self.w_out = nn.Parameter(w_out)


def mlp_init(gen, cfg: ModelConfig, d_ff=None, dtype=torch.float32,
             device=None) -> MLP:
    d_ff = d_ff or cfg.d_ff
    return MLP(_init(gen, (cfg.d_model, d_ff), dtype=dtype, device=device),
               _init(gen, (cfg.d_model, d_ff), dtype=dtype, device=device),
               _init(gen, (d_ff, cfg.d_model), dtype=dtype, device=device))


def mlp_apply(p: MLP, x, cfg: ModelConfig, plan: ShardingPlan):
    h = act_fn(cfg.act)(x @ p.w_gate) * (x @ p.w_in)
    return h @ p.w_out


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


class Embed(nn.Module):
    """embedding: (vocab, d_model); unembed: (d_model, vocab), or None when
    the embeddings are tied."""

    def __init__(self, embedding, unembed: Optional[torch.Tensor] = None):
        super().__init__()
        self.embedding = nn.Parameter(embedding)
        self.unembed = None if unembed is None else nn.Parameter(unembed)


def embed_init(gen, cfg: ModelConfig, dtype=torch.float32,
               device=None) -> Embed:
    emb = _init(gen, (cfg.vocab, cfg.d_model), scale=1.0, dtype=dtype,
                device=device)
    unemb = None
    if not cfg.tie_embeddings:
        unemb = _init(gen, (cfg.d_model, cfg.vocab), dtype=dtype,
                      device=device)
    return Embed(emb, unemb)


def embed_apply(p: Embed, tokens, cfg: ModelConfig, plan: ShardingPlan):
    x = F.embedding(tokens, p.embedding)
    # sqrt(d_model) rounded in the activation dtype, as the reference does
    return x * torch.tensor(cfg.d_model, dtype=x.dtype) ** 0.5


def unembed_apply(p: Embed, x, cfg: ModelConfig, plan: ShardingPlan,
                  apply_softcap: bool = True):
    if cfg.tie_embeddings:
        logits = x @ p.embedding.T
    else:
        logits = x @ p.unembed
    if apply_softcap:
        # in train mode the softcap belongs to the loss instead
        logits = softcap(logits, cfg.final_softcap)
    return logits
