"""The collectives of the distributed layer, over ``torch.distributed``.

The reference reduces over mesh axis names inside ``shard_map`` (``psum``,
``pmax``, ``pmin``, ``all_gather``); the port reduces over process groups.
``axes`` is a ``ProcessGroup``, a sequence of them (reduced over in turn,
as the reference reduces over each axis name in turn) or ``None`` for the
default group.

The rule for sums, which keeps every rank on the same branch of the round
loop and every run on the same bits:

* integer tensors go through ``all_reduce`` SUM, which is exact;
* float tensors (the small per-round vectors: partials, slot masses and
  sums, totals, the finalize's masses) are gathered from every rank and
  summed in rank order on every rank (:func:`psum`): the same bits on every
  rank and every run, whichever backend carries them;
* :func:`psum_backend` is ``all_reduce`` SUM for float vectors too, in the
  backend's order (the same bits on every rank under gloo's and NCCL's
  algorithms).  Only the coordinate-sized vectors of the across-axis paths
  use it, where a gather would cost ``n_rep`` times their size.

Minima and maxima go through ``all_reduce`` MIN / MAX (exact).  Gloo takes
every one of these collectives on CUDA tensors as well as on CPU tensors,
so nothing here copies to the host; NCCL takes them on CUDA tensors.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def groups(axes) -> tuple:
    """``axes`` as a tuple of process groups (``None``: the default
    group)."""
    if axes is None or isinstance(axes, dist.ProcessGroup):
        return (axes,)
    return tuple(axes)


def axis_size(axes) -> int:
    """The number of ranks over all of ``axes``."""
    size = 1
    for g in groups(axes):
        size *= dist.get_world_size(g)
    return size


def _all_reduce(t: torch.Tensor, axes, op) -> torch.Tensor:
    out = t.reshape(-1).clone()
    for g in groups(axes):
        dist.all_reduce(out, op=op, group=g)
    return out.view(t.shape)


def _gather(t: torch.Tensor, g) -> list:
    flat = t.reshape(-1).contiguous()
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(g))]
    dist.all_gather(parts, flat, group=g)
    return [p.view(t.shape) for p in parts]


def psum(t: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axes``, on every rank: exact
    ``all_reduce`` for integers; for floats each group's tensors gathered
    and added in rank order, ``((t_0 + t_1) + t_2) + ...``."""
    if not t.dtype.is_floating_point:
        return _all_reduce(t, axes, dist.ReduceOp.SUM)
    for g in groups(axes):
        parts = _gather(t, g)
        t = parts[0]
        for p in parts[1:]:
            t = t + p
    return t


def psum_backend(t: torch.Tensor, axes) -> torch.Tensor:
    """``all_reduce`` SUM over ``axes``, in the backend's order (for the
    coordinate-sized float vectors of the across-axis paths)."""
    return _all_reduce(t, axes, dist.ReduceOp.SUM)


def pmax(t: torch.Tensor, axes) -> torch.Tensor:
    return _all_reduce(t, axes, dist.ReduceOp.MAX)


def pmin(t: torch.Tensor, axes) -> torch.Tensor:
    return _all_reduce(t, axes, dist.ReduceOp.MIN)


def all_gather(t: torch.Tensor, axes, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in rank order, one
    group after the other (the reference's ``all_gather`` over each axis,
    then a reshape that merges the new axis into ``dim``)."""
    for g in groups(axes):
        t = torch.cat(_gather(t, g), dim=dim)
    return t
