"""Decoder-only LM assembled from a repeating layer-pattern unit, ported
from ``repro.models.transformer``.

The reference scans over ``cfg.n_units`` repeats of the pattern unit and
applies the remainder layers after the scan.  The port keeps the layers in
that order in one ``nn.ModuleList`` (unit u, position i at ``u * len(unit)
+ i``, then the remainder) and runs them in a Python loop; with
``cfg.remat == "full"`` a training forward recomputes each layer in
backward (``torch.utils.checkpoint``), as the reference remats each unit.

The decode cache (:class:`DecodeCache`) is a list of per-layer dicts in the
same order, written in place, so a step needs no host sync.  The
reference's decode is functional: an old cache stays valid after a step.
The port's is not, so its cache records the next position as a Python int
and ``decode_step`` refuses any other; a caller that decodes again from an
earlier position (a shared prompt prefix, a retry) keeps a
:func:`copy_cache` taken there.

The layer kinds ``attn`` and ``local`` are ported.  RWKV and RG-LRU
mixers, the MoE feed-forward and a plan with a mesh raise
``NotImplementedError`` naming their ROADMAP item before anything is
allocated or computed.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, LOCAL, MOE, RECURRENT, RGLRU,
                                      RWKV, SHARDING, ModelConfig,
                                      ShardingPlan, not_ported)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L


def check_ported(cfg: ModelConfig, plan: ShardingPlan = None) -> None:
    """Raise for what the port's decoder does not run yet."""
    for kind in cfg.unit:
        if kind in (RWKV, RGLRU):
            raise not_ported(f"the {kind} mixer ({cfg.name})", RECURRENT)
        if kind not in (ATTN, LOCAL):
            raise ValueError(kind)
    if cfg.moe is not None:
        raise not_ported(f"the MoE feed-forward ({cfg.name})", MOE)
    if plan is not None and plan.mesh is not None:
        raise not_ported("the decoder on a DeviceMesh", SHARDING)


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's kind in the order the layers are applied."""
    return list(cfg.unit) * cfg.n_units + list(cfg.remainder)


# ---------------------------------------------------------------------------
# per-layer init/apply
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One pre-norm block: ``ln1``, ``mixer`` (attention), ``ln2``, ``ffn``
    (gated MLP)."""

    def __init__(self, kind: str, ln1, ln2, mixer: attn.Attention,
                 ffn: L.MLP):
        super().__init__()
        self.kind = kind
        self.ln1 = nn.Parameter(ln1)
        self.ln2 = nn.Parameter(ln2)
        self.mixer = mixer
        self.ffn = ffn


class Decoder(nn.Module):
    """``embed``, ``layers`` (in the order they are applied) and
    ``final_norm``; ``unit_len`` is ``len(cfg.unit)``: the first
    ``len(layers) // unit_len`` units of layers are the reference's stacked
    ``units``, the rest its ``rem_i`` layers."""

    def __init__(self, embed: L.Embed, layers, final_norm, unit_len: int):
        super().__init__()
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = nn.Parameter(final_norm)
        self.unit_len = unit_len

    def param_groups(self) -> Dict[str, Tuple[List[str], bool]]:
        """The reference's parameter leaves over the port's names: group key
        -> (member names, stacked).  Unit position i's ``rest`` (e.g.
        ``mixer.wq``) is one stacked leaf of the reference, key
        ``units.{i}.{rest}``, members ``layers.{u * unit_len + i}.{rest}``
        for u = 0 .. n_units - 1; every other parameter is a leaf alone,
        keyed by its own name.  Adafactor's factoring and update clip, and
        int8 compression's scale, act on these leaves."""
        stacked = len(self.layers) // self.unit_len * self.unit_len
        groups: Dict[str, Tuple[List[str], bool]] = {}
        for name, _ in self.named_parameters():
            head, j, rest = (name.split(".", 2) + ["", ""])[:3]
            if head == "layers" and int(j) < stacked:
                key = f"units.{int(j) % self.unit_len}.{rest}"
                groups.setdefault(key, ([], True))[0].append(name)
            else:
                groups[name] = ([name], False)
        return groups


class DecodeCache(list):
    """The decode cache: one dict of tensors a layer, in the order the
    layers run, and ``next_pos``, the position (a Python int) that the next
    ``decode_step`` must be given.  Steps write the tensors in place; see
    :func:`copy_cache` to keep a cache to decode from again."""

    def __init__(self, layers=(), next_pos: int = 0):
        super().__init__(layers)
        self.next_pos = next_pos


def copy_cache(cache: DecodeCache) -> DecodeCache:
    """A copy of ``cache`` (every tensor cloned, and its next position)
    that later steps on either do not touch: the way to decode again from
    this position, e.g. several continuations of one prompt."""
    return DecodeCache(
        ({k: v.clone() for k, v in layer.items()} for layer in cache),
        cache.next_pos)


def _layer_init(gen, kind: str, cfg: ModelConfig, dtype, device) -> Block:
    d = (cfg.d_model,)
    return Block(kind, L._zeros(d, dtype, device), L._zeros(d, dtype, device),
                 attn.attn_init(gen, cfg, dtype, device),
                 L.mlp_init(gen, cfg, dtype=dtype, device=device))


def _theta(kind: str, cfg: ModelConfig) -> float:
    if kind == ATTN and cfg.rope_theta_global:
        return cfg.rope_theta_global
    return cfg.rope_theta


def _layer_apply(kind, p: Block, x, positions, cfg, plan, cache, mode,
                 index=None):
    """One block: mixer + ffn with pre-norms. Returns (x, new_cache); in
    decode mode ``index`` is the position, a Python int."""
    h = L.rms_norm(x, p.ln1, cfg.norm_eps)
    new_cache = None
    q, k, v = attn.qkv_proj(p.mixer, h, positions, cfg, plan,
                            _theta(kind, cfg))
    if mode == "decode":
        decode = attn.decode_ring if kind == LOCAL else attn.decode_global
        new_cache, o = decode(cache, q, k, v, index, cfg, plan,
                              cfg.attn_softcap)
    else:
        window = cfg.window if kind == LOCAL else 0
        o = attn.flash_attention(q, k, v, causal=True, window=window,
                                 chunk=cfg.attn_chunk, cap=cfg.attn_softcap)
    x = x + attn.out_proj(p.mixer, o, cfg, plan)
    h2 = L.rms_norm(x, p.ln2, cfg.norm_eps)
    return x + L.mlp_apply(p.ffn, h2, cfg, plan), new_cache


def _layer_cache(kind, cfg, batch, max_seq, plan, dtype, device):
    if kind == ATTN:
        return attn.init_global_cache(cfg, batch, max_seq, plan, dtype,
                                      device)
    if kind == LOCAL:
        return attn.init_ring_cache(cfg, batch, plan, dtype, device)
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# full decoder
# ---------------------------------------------------------------------------


def init_decoder(gen, cfg: ModelConfig, dtype=torch.float32,
                 device=None) -> Decoder:
    check_ported(cfg)
    embed = L.embed_init(gen, cfg, dtype, device)
    blocks = [_layer_init(gen, kind, cfg, dtype, device)
              for kind in layer_kinds(cfg)]
    return Decoder(embed, blocks, L._zeros((cfg.d_model,), dtype, device),
                   len(cfg.unit))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               plan: ShardingPlan, dtype=torch.bfloat16,
               device=None) -> DecodeCache:
    """An empty cache whose next position is 0."""
    check_ported(cfg, plan)
    return DecodeCache(_layer_cache(kind, cfg, batch, max_seq, plan, dtype,
                                    device) for kind in layer_kinds(cfg))


def _embed_inputs(params: Decoder, batch, cfg: ModelConfig,
                  plan: ShardingPlan):
    """tokens (+ optional stub frontend embeddings) -> (B, S, D)."""
    x = L.embed_apply(params.embed, batch["tokens"], cfg, plan)
    if cfg.frontend == "patch_stub" and "patches" in batch:
        # [vlm]: precomputed patch embeddings prepended to the text tokens
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
    return x


def _blocks(params: Decoder, cfg: ModelConfig):
    return zip(layer_kinds(cfg), params.layers, strict=True)


def _layer_forward(kind, p, x, positions, cfg, plan, mode):
    return _layer_apply(kind, p, x, positions, cfg, plan, None, mode)[0]


def forward(params: Decoder, batch, cfg: ModelConfig, plan: ShardingPlan, *,
            mode: str = "train", return_hidden: bool = False):
    """Full-sequence forward (train / prefill). Returns (logits, aux), or
    (normed hidden states, aux) when ``return_hidden`` (the fused-loss
    path); the final softcap applies outside train mode; ``aux`` holds the
    reference's MoE terms, zero for the dense decoder.  With
    ``cfg.remat == "full"``, in train mode under autograd, each layer's
    activations are recomputed in backward."""
    check_ported(cfg, plan)
    x = _embed_inputs(params, batch, cfg, plan)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = (cfg.remat == "full" and mode == "train"
             and torch.is_grad_enabled())
    for kind, p in _blocks(params, cfg):
        if remat:
            x = checkpoint(_layer_forward, kind, p, x, positions, cfg, plan,
                           mode, use_reentrant=False)
        else:
            x = _layer_forward(kind, p, x, positions, cfg, plan, mode)
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    aux = {"moe_aux": zero, "moe_z": zero}
    if return_hidden:
        return x, aux
    logits = L.unembed_apply(params.embed, x, cfg, plan,
                             apply_softcap=(mode != "train"))
    return logits, aux


def decode_step(params: Decoder, cache: DecodeCache, token, index: int,
                cfg: ModelConfig, plan: ShardingPlan):
    """One-token decode. token: (B, 1) int; index: the position, a Python
    int, which must be the cache's ``next_pos``.  Returns (logits (B,1,V),
    cache), the cache written in place and its ``next_pos`` advanced."""
    check_ported(cfg, plan)
    index = int(index)
    want = getattr(cache, "next_pos", None)
    if index != want:
        raise ValueError(
            f"decode_step at position {index} on a cache whose next "
            f"position is {want}: the port writes the cache in place, so a "
            f"cache decodes each position once, in order (the reference's "
            f"decode is functional and leaves an old cache usable).  To "
            f"decode again from an earlier position keep a "
            f"models.model.copy_cache taken there; a cache must come from "
            f"model.init_cache")
    x = L.embed_apply(params.embed, token, cfg, plan)
    positions = torch.full((1,), index, dtype=torch.int32, device=x.device)
    for j, (kind, p) in enumerate(_blocks(params, cfg)):
        x, cache[j] = _layer_apply(kind, p, x, positions, cfg, plan,
                                   cache[j], "decode", index)
    cache.next_pos = index + 1
    x = L.rms_norm(x, params.final_norm, cfg.norm_eps)
    return L.unembed_apply(params.embed, x, cfg, plan), cache
