"""Crossing point between numpy (and the reference package) and the port.

Input arrays enter the port through :func:`from_numpy`, which places them
on the card unless the caller names another device: nothing slides onto
the CPU silently.  The selection path has no learned parameters; the state
that crosses between the reference and the port is input arrays and
results, so :func:`select_result_from_numpy` carries a result across,
and :func:`prior_from_numpy` a warm-start prior.  The LM substrate's
weights cross through :func:`params_from_numpy`.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import _device
from repro_torch.core.selection import Prior, SelectResult


def from_numpy(x, device=None) -> torch.Tensor:
    """A tensor with ``x``'s values and dtype on ``device``.

    ``device=None`` means the card (``cuda``) and raises when no GPU is
    present; the CPU must be asked for by name (``device="cpu"``).
    """
    device = _device.resolve(device, "from_numpy")
    # a copy: the tensor never aliases the caller's (possibly read-only)
    # array
    return torch.tensor(np.asarray(x), device=device)


def select_result_from_numpy(res, device=None) -> SelectResult:
    """The port's :class:`SelectResult` from any object with the fields
    ``value, iters, status, y_lo, y_hi, n_in`` as numpy arrays (for
    example the reference's result after ``np.asarray`` on each field)."""
    return SelectResult(*(from_numpy(np.asarray(getattr(res, f)), device)
                          for f in SelectResult._fields))


def prior_from_numpy(prior, device=None) -> Prior:
    """The port's warm-start :class:`Prior` from any object with the fields
    ``value, y_lo, y_hi`` and, optionally, ``cut`` as numpy arrays (the
    reference's ``Prior``, or its ``SelectResult``, whose answer doubles as
    the cut)."""
    cut = getattr(prior, "cut", None)
    return Prior(*(from_numpy(np.asarray(v), device) for v in (
        prior.value, prior.y_lo, prior.y_hi,
        prior.value if cut is None else cut)))


def _block_from_numpy(kind, tree, t):
    from repro_torch.models import attention, layers, transformer

    mixer, ffn = tree["mixer"], tree["ffn"]
    norms = ((t(mixer["q_norm"]), t(mixer["k_norm"])) if "q_norm" in mixer
             else (None, None))
    return transformer.Block(
        kind, t(tree["ln1"]), t(tree["ln2"]),
        attention.Attention(t(mixer["wq"]), t(mixer["wk"]), t(mixer["wv"]),
                            t(mixer["wo"]), *norms),
        layers.MLP(t(ffn["w_gate"]), t(ffn["w_in"]), t(ffn["w_out"])))


def _unit_slice(tree, u: int):
    """Unit ``u`` of a subtree whose leaves are stacked on dim 0."""
    if isinstance(tree, dict):
        return {k: _unit_slice(v, u) for k, v in tree.items()}
    return tree[u]


def params_from_numpy(tree, cfg, device=None):
    """The port's decoder from the reference's parameter pytree (each leaf
    a numpy array, e.g. after ``np.asarray``): the ``units`` leaves, stacked
    over ``n_units``, are unstacked into layer ``u * len(unit) + i``, then
    the ``rem_i`` layers follow.  The port keeps the reference's layouts
    ((d_model, H, hd) / (H, hd, d_model) projections), so no leaf is
    transposed.  ``device=None`` means the card.  Returns a
    ``repro_torch.models.transformer.Decoder``.  The model layer is
    imported here, so the selection callers of this module do not load
    it."""
    from repro_torch.models import layers, transformer

    transformer.check_ported(cfg)
    device = _device.resolve(device, "params_from_numpy")

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    blocks = [_block_from_numpy(kind, _unit_slice(tree["units"][i], u), t)
              for u in range(cfg.n_units)
              for i, kind in enumerate(cfg.unit)]
    blocks += [_block_from_numpy(kind, tree[f"rem_{i}"], t)
               for i, kind in enumerate(cfg.remainder)]
    emb = tree["embed"]
    embed = layers.Embed(t(emb["embedding"]),
                         None if cfg.tie_embeddings else t(emb["unembed"]))
    return transformer.Decoder(embed, blocks, t(tree["final_norm"]))
