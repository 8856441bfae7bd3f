"""Config system: model architecture, input shapes, sharding plan.

The port's copy of ``repro.configs.base``: the same layer kinds,
``MoEConfig``, ``ModelConfig`` (``hd``, ``unit``, ``n_units``,
``remainder`` and ``reduced()`` as the reference has them), ``ShapeConfig``
and ``SHAPES``.  Its ``ShardingPlan`` holds a
``torch.distributed.DeviceMesh`` (or ``None``) and the mesh dim names in
place of JAX's mesh and ``PartitionSpec``s; the models run without a mesh
and raise on a plan that has one (the sharded model is ROADMAP Queue 1
item 11f).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional, Tuple

# layer-pattern mixer kinds
ATTN = "attn"        # full (causal) attention
LOCAL = "local"      # sliding-window attention
RWKV = "rwkv"        # RWKV-6 (Finch) data-dependent-decay mixer
RGLRU = "rglru"      # RecurrentGemma RG-LRU recurrent block

# ROADMAP Queue 1 items of the LM substrate that the port does not have yet
MOE = "11c (MoE)"
RECURRENT = "11d (RWKV and RG-LRU)"
ENCDEC = "11e (enc-dec)"
SHARDING = "11f (sharding on a DeviceMesh)"


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error raised where a path of the reference is not ported yet."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP Queue 1 item "
        f"{item})")


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ffn: int
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # 'decoder' | 'encdec'
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    layer_pattern: Tuple[str, ...] = (ATTN,)
    window: int = 4096           # sliding window for LOCAL layers
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0   # gemma3: different theta for global
    qk_norm: bool = False
    attn_softcap: float = 0.0    # 0 = off (gemma2: 50.0)
    final_softcap: float = 0.0   # gemma2: 30.0
    act: str = "silu"            # 'silu' | 'gelu'
    moe: Optional[MoEConfig] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    frontend: Optional[str] = None   # None | 'patch_stub' | 'audio_stub'
    n_frontend_tokens: int = 0       # vlm: image patch token count
    enc_layers: int = 0              # encdec: encoder depth
    fsdp: bool = False               # shard params over data axis too
    sub_quadratic: bool = False      # eligible for long_500k
    # training-time defaults
    remat: str = "full"              # 'none' | 'full' (per-block remat)
    attn_chunk: int = 1024           # flash-attention KV chunk
    rwkv_chunk: int = 64
    head_dim_v: int = 0              # rwkv: value head dim (== head_dim)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def unit(self) -> Tuple[str, ...]:
        return self.layer_pattern

    @property
    def n_units(self) -> int:
        return self.n_layers // len(self.unit)

    @property
    def remainder(self) -> Tuple[str, ...]:
        """Layers beyond the repeated units (pattern prefix)."""
        r = self.n_layers - self.n_units * len(self.unit)
        return self.unit[:r]

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        unit = self.layer_pattern
        kw = dict(
            n_layers=len(unit) * 2 + len(self.remainder),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 2,
            head_dim=16,
            d_ff=128,
            vocab=512,
            window=8,
            attn_chunk=16,
            rwkv_chunk=8,
            n_frontend_tokens=min(self.n_frontend_tokens, 8),
            enc_layers=2 if self.enc_layers else 0,
            fsdp=False,
            remat="none",
        )
        if self.moe is not None:
            kw["moe"] = MoEConfig(
                num_experts=min(self.moe.num_experts, 4),
                top_k=min(self.moe.top_k, 2),
                expert_ffn=32,
            )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(name)]


@dataclass(frozen=True)
class ShardingPlan:
    """How the model maps onto a ``DeviceMesh``.  mesh=None => one device.

    ``mesh`` is a ``torch.distributed.DeviceMesh`` with named dims; the
    ``*_axes`` / ``*_axis`` fields name its dims, as the reference's name
    its mesh axes.
    """
    mesh: Optional[Any] = None
    dp_axes: Tuple[str, ...] = ()     # batch axes, e.g. ('pod', 'data')
    tp_axis: Optional[str] = None     # tensor-parallel axis name
    fsdp_axis: Optional[str] = None   # param shard axis (ZeRO-3 style)
    seq_axes: Tuple[str, ...] = ()    # KV-sequence shards for long decode

    @property
    def tp(self) -> int:
        if self.mesh is None or self.tp_axis is None:
            return 1
        return _axis_size(self.mesh, self.tp_axis)

    @property
    def dp(self) -> int:
        if self.mesh is None:
            return 1
        n = 1
        for a in self.dp_axes:
            n *= _axis_size(self.mesh, a)
        return n

    def shard(self, x, spec=None):
        """The reference's sharding constraint: nothing without a mesh."""
        if self.mesh is None:
            return x
        raise not_ported("placing tensors on a DeviceMesh", SHARDING)


def local_plan() -> ShardingPlan:
    return ShardingPlan()
