"""int8 gradient compression with stochastic rounding, ported from
``repro.optim.compress``: gradients quantized before a cross-replica
combine and dequantized after.  The scale is a leaf's max |g| / 127.

The leaves are the reference's: a decoder's ``param_groups()`` stacks a
unit position's layers into one leaf with one scale.  The noise comes from
an explicit ``torch.Generator`` (the reference's ``jax.random`` draws are
not reproduced)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.optim._tree import gather, scatter


def int8_compress(gen: torch.Generator, tree, groups: Optional[Dict] = None):
    """``tree``: ``{name: tensor}``; ``groups``: group key -> (names,
    stacked), e.g. ``decoder.param_groups()`` (default: every tensor
    alone).  Returns ``({key: {'q': int8, 'scale': f32}}, gen)``, the
    generator advanced."""
    if groups is None:
        groups = {name: ([name], False) for name in tree}
    out = {}
    for key, (names, stacked) in groups.items():
        g = gather(tree, names, stacked).to(torch.float32)
        scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / 127.0
        x = g / scale
        noise = torch.rand(g.shape, generator=gen, dtype=torch.float32,
                           device=g.device) - 0.5
        q = torch.clamp(torch.round(x + noise), -127, 127).to(torch.int8)
        out[key] = {"q": q, "scale": scale}
    return out, gen


def int8_decompress(ctree, groups: Optional[Dict] = None):
    """``q * scale`` in f32 for each entry of ``ctree``; with ``groups``
    (as given to :func:`int8_compress`), unstacked to ``{name: tensor}``."""
    out = {key: c["q"].to(torch.float32) * c["scale"]
           for key, c in ctree.items()}
    if groups is None:
        return out
    named = {}
    for key, (names, stacked) in groups.items():
        named.update(scatter(out[key], names, stacked))
    return named
