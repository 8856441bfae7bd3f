"""The parameters an optimizer sees: a decoder's named tensors, grouped as
the reference's parameter pytree groups them."""
from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import torch
from torch import nn


def named(params) -> Dict[str, torch.Tensor]:
    """``{name: tensor}`` of a module's parameters (``state_dict`` names),
    or of a mapping as given."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def groups(params) -> Dict[str, Tuple[List[str], bool]]:
    """group key -> (member names, stacked): a decoder's
    ``param_groups()`` (the reference's stacked ``units`` leaves), else
    every tensor a group of its own."""
    if hasattr(params, "param_groups"):
        return params.param_groups()
    return {name: ([name], False) for name in named(params)}


def clone(tree):
    """A copy of a nested ``{key: tensor}`` state: every tensor cloned."""
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def gather(tensors: Mapping[str, torch.Tensor], names: List[str],
           stacked: bool) -> torch.Tensor:
    """A group's tensors as the reference's leaf: stacked on a new dim 0."""
    if stacked:
        return torch.stack([tensors[n] for n in names])
    return tensors[names[0]]


def scatter(value: torch.Tensor, names: List[str], stacked: bool):
    """``{name: tensor}`` of a group's leaf (inverse of :func:`gather`)."""
    if stacked:
        return dict(zip(names, value.unbind(0)))
    return {names[0]: value}
