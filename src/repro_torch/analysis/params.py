"""Parameter counts (total + MoE-active) over a module's named parameters,
ported from ``repro.analysis.params``."""
from __future__ import annotations

from torch import nn

from repro_torch.configs.base import ModelConfig


def param_counts(params: nn.Module, cfg: ModelConfig):
    """(total_params, active_params). Active scales MoE expert tensors by
    top_k / num_experts (the dense-equivalent compute size).  Works on a
    model built on the ``meta`` device too."""
    total = 0
    active = 0
    for name, leaf in params.named_parameters():
        names = name.split(".")
        n = leaf.numel()
        total += n
        if (cfg.moe is not None and "ffn" in names
                and names[-1] in ("w_gate", "w_in", "w_out")
                and leaf.dim() >= 3):
            n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        active += n
    return total, active
