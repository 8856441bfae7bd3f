"""Model dispatch, ported from ``repro.models.model``.

``init``, ``forward``, ``init_cache`` and ``decode_step`` for the decoder
family; the encoder-decoder family (whisper) raises ``NotImplementedError``
(ROADMAP Queue 1 item 11e).  The sharding rules (``param_specs``,
``cache_specs``) and the LM losses come with the sharding and training
slices (items 11f and 11b).

``init`` and ``init_cache`` allocate on ``device``, which defaults to the
card and raises when there is none: the CPU must be asked for by name.
"""
from __future__ import annotations

import torch

from repro_torch import _device
from repro_torch.configs.base import (ENCDEC, ModelConfig, ShardingPlan,
                                      not_ported)
from repro_torch.models import transformer


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
            mode="train"):
    _check(cfg, plan)
    return transformer.forward(params, batch, cfg, plan, mode=mode)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               plan: ShardingPlan, dtype=torch.bfloat16, enc_seq: int = 0,
               device=None):
    _check(cfg, plan)
    device = _device.resolve(device, "model.init_cache")
    return transformer.init_cache(cfg, batch, max_seq, plan, dtype, device)


def decode_step(params, cache, token, index, cfg: ModelConfig,
                plan: ShardingPlan):
    _check(cfg, plan)
    return transformer.decode_step(params, cache, token, index, cfg, plan)
