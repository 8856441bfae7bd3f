"""Dispatch between the CUDA kernels and their plain versions.

The rule, decided by the tensor alone:

* a CUDA tensor of f32 or bf16 goes to the kernel;
* f64 goes to the plain version on any device — the kernels accumulate in
  f32, so two f64 values straddling a pivot could collapse onto it and the
  exactness certificates would lie (the reference's dtype rule);
* a CPU tensor goes to the plain version.

Any other CUDA tensor reaches the kernel wrapper, which raises.  There is
no fallback on error: a kernel that cannot run raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cp_objective, ref


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether a data pass over ``x`` runs a CUDA kernel (the rule above)."""
    return x.device.type == "cuda" and x.dtype != torch.float64


def fused_partials_batched(x: torch.Tensor, y: torch.Tensor):
    """``(sum_pos, sum_neg, n_lt, n_le)`` per row of ``x`` (B, n) at the
    pivots ``y`` (B,)."""
    if uses_kernel(x):
        return cp_objective.cp_partials_batched(x, y)
    return ref.cp_partials_batched_ref(x, y)


def fused_histogram_batched(x: torch.Tensor, edges: torch.Tensor):
    """Row-wise binned pass, counting leg: ``x`` (B, n), per-row realized
    edges ``(B, nbins+1)`` -> ``(cnt, None)``, ``cnt`` int32
    ``(B, nbins + 2)``."""
    if uses_kernel(x):
        return cp_objective.cp_histogram_batched(x, edges)
    return ref.cp_histogram_batched_ref(x, edges, want_sums=False)


def fused_partials_multi(x: torch.Tensor, y: torch.Tensor):
    """``(sum_pos, sum_neg, n_lt, n_le)`` of one shared ``x`` (n,) at each
    of the pivots ``y`` (K,)."""
    if uses_kernel(x):
        return cp_objective.cp_partials_multi(x, y)
    return ref.cp_partials_multi_ref(x, y)


def fused_histogram_multi(x: torch.Tensor, edges: torch.Tensor):
    """Shared-x binned pass, counting leg: ``x`` (n,) against K realized
    ladders ``(K, nbins+1)`` -> ``(cnt, None)``, ``cnt`` int32
    ``(K, nbins + 2)``."""
    if uses_kernel(x):
        return cp_objective.cp_histogram_multi(x, edges)
    return ref.cp_histogram_multi_ref(x, edges, want_sums=False)


def fused_partials(x: torch.Tensor, y):
    """The K=1 view of :func:`fused_partials_multi`: a scalar pivot."""
    if uses_kernel(x):
        return cp_objective.cp_partials(x, y)
    return ref.cp_partials_ref(x, y)


def fused_histogram(x: torch.Tensor, edges: torch.Tensor):
    """The K=1 view of :func:`fused_histogram_multi`: one ladder
    ``(nbins+1,)`` -> ``(cnt, None)``, ``cnt`` ``(nbins + 2,)``."""
    if uses_kernel(x):
        return cp_objective.cp_histogram(x, edges)
    return ref.cp_histogram_ref(x, edges, want_sums=False)
