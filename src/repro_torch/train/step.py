"""Step factories, ported from ``repro.train.step``: the prefill step and
the serve step (greedy decode).  Both run under ``torch.inference_mode()``.
The train step (with the quantile clip) comes with the training slice
(ROADMAP Queue 1 item 11b).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShardingPlan
from repro_torch.models import model


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
    logits, new_cache) — greedy argmax (the first maximum) as int32."""

    def serve_step(params, cache, token, index):
        with torch.inference_mode():
            logits, new_cache = model.decode_step(params, cache, token,
                                                  index, cfg, plan)
            nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt[:, None], logits, new_cache

    return serve_step
