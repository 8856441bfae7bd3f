"""Attention, ported from ``repro.models.attention``: chunked-flash
prefill, cached decode (a global cache, and a ring buffer for sliding
windows).

PyTorch idiom: the reference's ``lax.scan`` over KV chunks is a Python
loop over the chunks with the same online softmax; its
``dynamic_update_slice`` into a cache is an in-place write at a Python-int
position, so a decode step needs no host sync.  Matmuls, einsums and the
softmax are plain torch in f32 (no library attention), as the reference's
are plain ``jnp``.  The sequence-sharded decode (``_seqshard_decode``)
waits for the sharded model (ROADMAP Queue 1 item 11f).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (SHARDING, ModelConfig, ShardingPlan,
                                      not_ported)
from repro_torch.models.layers import _init, _zeros, rms_norm, rope, softcap

NEG = -1e30


def attn_tp(cfg: ModelConfig, plan: ShardingPlan) -> int:
    """TP degree usable for attention heads (1 => replicated attention)."""
    tp = plan.tp
    return tp if cfg.n_heads % tp == 0 else 1


def eff_kv(cfg: ModelConfig, plan: ShardingPlan) -> int:
    """KV head count after replication up to the attention TP degree."""
    tp = attn_tp(cfg, plan)
    kv = cfg.n_kv_heads
    if kv % tp == 0:
        return kv
    if tp % kv:
        raise ValueError(f"{cfg.name}: {kv} kv heads on a {tp}-way TP axis")
    return tp


def head_spec(cfg: ModelConfig, plan: ShardingPlan):
    """Axis name for sharding head dims (None if attention is replicated)."""
    return plan.tp_axis if attn_tp(cfg, plan) > 1 else None


class Attention(nn.Module):
    """wq: (d_model, H, hd); wk, wv: (d_model, E, hd); wo: (H, hd,
    d_model); q_norm, k_norm: (hd,) with qk-norm, else None."""

    def __init__(self, wq, wk, wv, wo, q_norm: Optional[torch.Tensor] = None,
                 k_norm: Optional[torch.Tensor] = None):
        super().__init__()
        self.wq = nn.Parameter(wq)
        self.wk = nn.Parameter(wk)
        self.wv = nn.Parameter(wv)
        self.wo = nn.Parameter(wo)
        self.q_norm = None if q_norm is None else nn.Parameter(q_norm)
        self.k_norm = None if k_norm is None else nn.Parameter(k_norm)


def attn_init(gen, cfg: ModelConfig, dtype=torch.float32,
              device=None) -> Attention:
    hd = cfg.hd
    kw = dict(dtype=dtype, device=device)
    norms = ((_zeros((hd,), dtype, device), _zeros((hd,), dtype, device))
             if cfg.qk_norm else (None, None))
    return Attention(_init(gen, (cfg.d_model, cfg.n_heads, hd), **kw),
                     _init(gen, (cfg.d_model, cfg.n_kv_heads, hd), **kw),
                     _init(gen, (cfg.d_model, cfg.n_kv_heads, hd), **kw),
                     _init(gen, (cfg.n_heads, hd, cfg.d_model), **kw),
                     *norms)


def _repeat_kv(k, v, cfg, plan):
    e = eff_kv(cfg, plan)
    rep = e // cfg.n_kv_heads
    if rep > 1:  # jnp.repeat: each head repeated in place
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return k, v


def _heads(x, w):
    """einsum('bsd,dhk->bshk') as one matmul over the flattened heads."""
    B, S, D = x.shape
    return (x @ w.reshape(D, -1)).view(B, S, w.shape[1], w.shape[2])


def qkv_proj(p: Attention, x, positions, cfg: ModelConfig,
             plan: ShardingPlan, theta: float):
    """Project + qk-norm + rope. Returns q:(B,S,H,hd), k/v:(B,S,eff,hd)."""
    q = _heads(x, p.wq)
    k = _heads(x, p.wk)
    v = _heads(x, p.wv)
    if cfg.qk_norm:
        q = rms_norm(q, p.q_norm, cfg.norm_eps)
        k = rms_norm(k, p.k_norm, cfg.norm_eps)
    if theta:
        q = rope(q, positions, theta)
        k = rope(k, positions, theta)
    k, v = _repeat_kv(k, v, cfg, plan)
    return q, k, v


def out_proj(p: Attention, o, cfg: ModelConfig, plan: ShardingPlan):
    """o: (B, S, H, hd) -> (B, S, D)."""
    B, S, H, hd = o.shape
    return o.reshape(B, S, H * hd) @ p.wo.reshape(H * hd, -1)


# ---------------------------------------------------------------------------
# Flash attention (prefill): a loop over KV chunks, online softmax
# ---------------------------------------------------------------------------


def _pad_seq(x, pad: int):
    """Zero-pad dim 1 of a (B, S, E, hd) tensor by ``pad``."""
    return F.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x


def banded_flash_attention(q, k, v, *, window: int, cap: float):
    """Sliding-window attention as a block-banded computation: query block i
    attends only to KV blocks {i-1, i} with block size == window.  Work is
    O(S * 2w) instead of the masked-full O(S^2).  Requires Sq == Skv."""
    B, S, H, hd = q.shape
    E = k.shape[2]
    G = H // E
    c = window
    dev = q.device
    pad = (-S) % c
    q, k, v = _pad_seq(q, pad), _pad_seq(k, pad), _pad_seq(v, pad)
    Sp = S + pad
    nb = Sp // c
    scale = hd ** -0.5
    qb = (q.reshape(B, nb, c, E, G, hd) * scale).float()
    kb = k.reshape(B, nb, c, E, hd)
    vb = v.reshape(B, nb, c, E, hd)
    # previous block (zeros before block 0, masked out by position)
    kp = torch.cat([torch.zeros_like(kb[:, :1]), kb[:, :-1]], dim=1)
    vp = torch.cat([torch.zeros_like(vb[:, :1]), vb[:, :-1]], dim=1)
    k2 = torch.cat([kp, kb], dim=2)  # (B, nb, 2c, E, hd)
    v2 = torch.cat([vp, vb], dim=2)
    s = torch.einsum("bntegk,bnsek->bnegts", qb, k2.float())
    if cap:
        s = softcap(s, cap)
    # positions within the band: query t (block-local), key s in [-c, c)
    tq = torch.arange(c, device=dev)[:, None]
    tk = torch.arange(2 * c, device=dev)[None, :] - c
    mask = (tk <= tq) & (tk > tq - window)
    # block 0 has no previous block
    first = torch.arange(nb, device=dev)[:, None, None] > 0
    mask = mask[None] & (first | (tk >= 0)[None])
    if pad:  # padded tail keys
        kpos = torch.arange(nb, device=dev)[:, None, None] * c + tk[None]
        mask = mask & (kpos < S)
    mask = mask[None, :, None, None]
    s = torch.where(mask, s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(mask, p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("bnegts,bnsek->bntegk", p / torch.clamp(l, min=1e-30),
                     v2.float())
    o = o.reshape(B, Sp, H, hd)[:, :S]
    return o.to(q.dtype)


def _flash_step(m, l, o, qr, ks, vs, pos_q, start: int, Skv: int,
                causal: bool, window: int, cap: float):
    """One KV chunk of the online softmax: keys ``start ..`` (padded keys
    at or past ``Skv`` masked).  Returns the new (m, l, o)."""
    chunk = ks.shape[1]
    s = torch.einsum("bsegk,btek->bsegt", qr, ks.float())
    if cap:
        s = softcap(s, cap)
    pos_k = start + torch.arange(chunk, device=qr.device)
    mask = (pos_k[None, :] < Skv).expand(pos_q.shape[0], chunk)
    if causal:
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    if window:
        mask = mask & (pos_k[None, :] > pos_q[:, None] - window)
    mask = mask[None, :, None, None, :]
    s = torch.where(mask, s, NEG)
    m_new = torch.maximum(m, torch.amax(s, dim=-1))
    p_ = torch.exp(s - m_new[..., None])
    p_ = torch.where(mask, p_, 0.0)
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + torch.sum(p_, dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bsegt,btek->bsegk", p_,
                                                vs.float())
    return m_new, l_new, o_new


def flash_attention(q, k, v, *, causal: bool, window: int, chunk: int,
                    cap: float, q_offset=0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,E,hd) with H % E == 0.  Online softmax
    over KV chunks; O(Sq*chunk) live score memory.  Sliding-window
    self-attention takes the block-banded path (O(S*2w) work)."""
    if (window and q.shape[1] == k.shape[1] and causal
            and q.shape[1] > window and window <= 2048):
        # larger windows would materialize (c x 2c) band blocks: they keep
        # the masked online softmax
        return banded_flash_attention(q, k, v, window=window, cap=cap)
    B, Sq, H, hd = q.shape
    Skv, E = k.shape[1], k.shape[2]
    G = H // E
    dev = q.device
    scale = hd ** -0.5
    qr = (q.reshape(B, Sq, E, G, hd) * scale).float()
    chunk = min(chunk, Skv)
    nchunks = -(-Skv // chunk)
    # pad KV; padded keys are masked by position
    k = _pad_seq(k, nchunks * chunk - Skv)
    v = _pad_seq(v, nchunks * chunk - Skv)
    pos_q = q_offset + torch.arange(Sq, device=dev)

    m = torch.full((B, Sq, E, G), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Sq, E, G), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Sq, E, G, hd), dtype=torch.float32, device=dev)
    # under autograd each chunk step is recomputed in backward, as the
    # reference remats its scan body: the (B, Sq, E, G, chunk) probabilities
    # are not kept for every chunk
    remat = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                         or v.requires_grad)
    for idx in range(nchunks):
        args = (m, l, o, qr, k[:, idx * chunk:(idx + 1) * chunk],
                v[:, idx * chunk:(idx + 1) * chunk], pos_q,
                idx * chunk, Skv, causal, window, cap)
        if remat:
            m, l, o = checkpoint(_flash_step, *args, use_reentrant=False)
        else:
            m, l, o = _flash_step(*args)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Sq, H, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# Decode with caches
# ---------------------------------------------------------------------------


def init_global_cache(cfg, batch, max_seq, plan: ShardingPlan,
                      dtype=torch.bfloat16, device=None):
    shp = (batch, max_seq, eff_kv(cfg, plan), cfg.hd)
    return {"k": _zeros(shp, dtype, device), "v": _zeros(shp, dtype, device)}


def init_ring_cache(cfg, batch, plan: ShardingPlan, dtype=torch.bfloat16,
                    device=None):
    shp = (batch, cfg.window, eff_kv(cfg, plan), cfg.hd)
    return {"k": _zeros(shp, dtype, device), "v": _zeros(shp, dtype, device),
            "pos": torch.full((cfg.window,), -1, dtype=torch.int32,
                              device=device)}


def _decode_scores(q, ks, vs, valid, cap):
    """q: (B,1,H,hd); ks/vs: (B,T,E,hd); valid: (T,) or (B,T)."""
    B, _, H, hd = q.shape
    E = ks.shape[2]
    G = H // E
    scale = hd ** -0.5
    qr = (q.reshape(B, E, G, hd) * scale).float()
    s = torch.einsum("begk,btek->begt", qr, ks.float())
    if cap:
        s = softcap(s, cap)
    if valid.dim() == 1:
        valid = valid[None, :]
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = torch.where(valid, p, 0.0)
    l = torch.sum(p, dim=-1, keepdim=True)
    o = torch.einsum("begt,btek->begk", p / torch.clamp(l, min=1e-30),
                     vs.float())
    return o.reshape(B, 1, H, hd).to(q.dtype)


def decode_global(cache, q, k_new, v_new, index: int, cfg, plan, cap=0.0):
    """One-token decode against a preallocated (B,S,E,hd) cache, written
    in place at ``index``.  Returns (cache, out)."""
    cache["k"][:, index] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, index] = v_new[:, 0].to(cache["v"].dtype)
    if plan.seq_axes and plan.mesh is not None:
        return cache, _seqshard_decode(q, cache["k"], cache["v"], index,
                                       cfg, plan, cap)
    valid = torch.arange(cache["k"].shape[1], device=q.device) <= index
    return cache, _decode_scores(q, cache["k"], cache["v"], valid, cap)


def decode_ring(cache, q, k_new, v_new, index: int, cfg, plan, cap=0.0):
    """One-token decode against a ring-buffer (window) cache, written in
    place at slot ``index % window``.  Returns (cache, out)."""
    w = cache["k"].shape[1]
    slot = index % w
    cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
    cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
    cache["pos"][slot] = index
    pos = cache["pos"]
    valid = (pos >= 0) & (pos > index - w)
    return cache, _decode_scores(q, cache["k"], cache["v"], valid, cap)


def _seqshard_decode(q, k_cache, v_cache, index, cfg, plan, cap):
    """Distributed flash-decode over a sequence-sharded cache."""
    raise not_ported("the sequence-sharded decode", SHARDING)
