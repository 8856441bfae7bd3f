"""Crossing point between numpy (and the reference package) and the port.

Input arrays enter the port through :func:`from_numpy`, which places them
on the card unless the caller names another device: nothing slides onto
the CPU silently.  The selection path has no learned parameters; the state
that crosses between the reference and the port is input arrays and
results, so :func:`select_result_from_numpy` carries a result across,
and :func:`prior_from_numpy` a warm-start prior.  The LM substrate's
weights cross through :func:`params_from_numpy`, an optimizer's state
through :func:`opt_state_from_numpy`.
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
    return transformer.Decoder(embed, blocks, t(tree["final_norm"]),
                               len(cfg.unit))


def _leaf_paths(tree, prefix=()):
    """(path, leaf) of a nested dict / list, in sorted-key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaf_paths(v, prefix + (str(i),))
    else:
        yield prefix, tree


def named_from_numpy(tree, cfg, *, stacked: bool = False):
    """The reference's parameter-shaped pytree (params, or an optimizer's
    ``m`` / ``v`` / ``master``) as ``{port name: numpy array}``: leaf
    ``units/i/<rest>``, stacked over ``n_units``, becomes
    ``layers.{u * len(unit) + i}.<rest>`` (as :func:`params_from_numpy`
    unstacks it), ``rem_i/<rest>`` the layer after the units, ``embed/*``
    and ``final_norm`` keep their names.  With ``stacked=True`` a units
    leaf stays whole under its group key ``units.{i}.<rest>`` (the port's
    ``Decoder.param_groups()`` keys)."""
    n_unit = len(cfg.unit)
    out = {}
    for path, leaf in _leaf_paths(tree):
        a = np.asarray(leaf)
        head, rest = path[0], ".".join(path[1:])
        if head == "units":
            i, rest = int(path[1]), ".".join(path[2:])
            if stacked:
                out[f"units.{i}.{rest}"] = a
            else:
                for u in range(cfg.n_units):
                    out[f"layers.{u * n_unit + i}.{rest}"] = a[u]
        elif head.startswith("rem_"):
            j = cfg.n_units * n_unit + int(head[4:])
            out[f"layers.{j}.{rest}"] = a
        else:
            out[".".join(path)] = a
    return out


def opt_state_from_numpy(ref_state, cfg, device=None):
    """The port's optimizer state from the reference's (leaves as numpy
    arrays): AdamW's ``m``, ``v`` and ``master`` unstacked to
    ``{name: tensor}`` as :func:`params_from_numpy` unstacks the params,
    and its ``count``; Adafactor's ``stats`` keyed by the port's groups
    (``Decoder.param_groups()``), a units leaf's statistics kept stacked
    as the reference's arithmetic needs them (a stacked norm scale's
    ``vc`` is shared by its units), and its ``count``.  ``device=None``
    means the card."""
    device = _device.resolve(device, "opt_state_from_numpy")

    def t(a):
        return torch.tensor(np.asarray(a), device=device)

    out = {"count": t(ref_state["count"])}
    if "stats" in ref_state:
        # a leaf's stats dict ({'vr', 'vc'} or {'v'}) is the unit of
        # grouping: key the leaf paths one level up
        stats = {}
        for key, a in named_from_numpy(ref_state["stats"], cfg,
                                       stacked=True).items():
            group, field = key.rsplit(".", 1)
            stats.setdefault(group, {})[field] = t(a)
        out["stats"] = stats
        return out
    for field in ("m", "v", "master"):
        if field in ref_state:
            out[field] = {n: t(a) for n, a in
                          named_from_numpy(ref_state[field], cfg).items()}
    return out
