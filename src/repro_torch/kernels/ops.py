"""Dispatch between the CUDA kernels and their plain versions.

The rule, decided by the tensor alone:

* a CUDA tensor of f32 or bf16 goes to the kernel;
* f64 goes to the plain version on any device — the kernels accumulate in
  f32, so two f64 values straddling a pivot could collapse onto it and the
  exactness certificates would lie (the reference's dtype rule);
* a CPU tensor goes to the plain version.

The weighted passes widen the rule to both operands: they take the kernel
only when neither ``x`` nor ``w`` is f64 (f64 weights on f32 data must
accumulate mass in f64, or the weighted certificates lie).

Any other CUDA tensor reaches the kernel wrapper, which raises.  There is
no fallback on error: a kernel that cannot run raises.

The six histogram passes take ``want_sums``: ``False`` (plain binned
sweeps) leaves the per-slot sums out (``None``); ``True`` (the polish, the
only reader) adds them — the kernels' sums legs K1s/K3s (Σx) and K1ws/K3ws
(Σw·x) on the card, the plain versions' sums elsewhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cp_objective, ref


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether a data pass over ``x`` runs a CUDA kernel (the rule above)."""
    return x.device.type == "cuda" and x.dtype != torch.float64


def uses_kernel_weighted(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether a weighted data pass over ``x``/``w`` runs a CUDA kernel:
    the rule of :func:`uses_kernel` on both operands."""
    return uses_kernel(x) and w.dtype != torch.float64


def fused_partials_batched(x: torch.Tensor, y: torch.Tensor):
    """``(sum_pos, sum_neg, n_lt, n_le)`` per row of ``x`` (B, n) at the
    pivots ``y`` (B,)."""
    if uses_kernel(x):
        return cp_objective.cp_partials_batched(x, y)
    return ref.cp_partials_batched_ref(x, y)


def fused_histogram_batched(x: torch.Tensor, edges: torch.Tensor, *,
                            want_sums: bool = False,
                            full_bracket: bool = False):
    """Row-wise binned pass, counting leg: ``x`` (B, n), per-row realized
    edges ``(B, nbins+1)`` -> ``(cnt, bsum)``, ``cnt`` int32
    ``(B, nbins + 2)``, ``bsum`` the per-slot sums of ``x`` with
    ``want_sums`` (else ``None``).  ``full_bracket`` (every element lies
    in its row's bracket) picks the kernel's design on the card."""
    if uses_kernel(x):
        return cp_objective.cp_histogram_batched(
            x, edges, want_sums=want_sums, full_bracket=full_bracket)
    return ref.cp_histogram_batched_ref(x, edges, want_sums=want_sums)


def fused_partials_multi(x: torch.Tensor, y: torch.Tensor):
    """``(sum_pos, sum_neg, n_lt, n_le)`` of one shared ``x`` (n,) at each
    of the pivots ``y`` (K,)."""
    if uses_kernel(x):
        return cp_objective.cp_partials_multi(x, y)
    return ref.cp_partials_multi_ref(x, y)


def fused_histogram_multi(x: torch.Tensor, edges: torch.Tensor, *,
                          want_sums: bool = False):
    """Shared-x binned pass, counting leg: ``x`` (n,) against K realized
    ladders ``(K, nbins+1)`` -> ``(cnt, bsum)``, ``cnt`` int32
    ``(K, nbins + 2)``, ``bsum`` as in :func:`fused_histogram_batched`."""
    if uses_kernel(x):
        return cp_objective.cp_histogram_multi(x, edges, want_sums=want_sums)
    return ref.cp_histogram_multi_ref(x, edges, want_sums=want_sums)


def fused_partials(x: torch.Tensor, y):
    """The K=1 view of :func:`fused_partials_multi`: a scalar pivot."""
    if uses_kernel(x):
        return cp_objective.cp_partials(x, y)
    return ref.cp_partials_ref(x, y)


def fused_histogram(x: torch.Tensor, edges: torch.Tensor, *,
                    want_sums: bool = False):
    """The K=1 view of :func:`fused_histogram_multi`: one ladder
    ``(nbins+1,)`` -> ``(cnt, bsum)``, each ``(nbins + 2,)``."""
    if uses_kernel(x):
        return cp_objective.cp_histogram(x, edges, want_sums=want_sums)
    return ref.cp_histogram_ref(x, edges, want_sums=want_sums)


def fused_weighted_partials_batched(x: torch.Tensor, w: torch.Tensor,
                                    y: torch.Tensor):
    """``(wsum_pos, wsum_neg, w_lt, w_le, n_lt, n_le)`` per row of
    ``x``/``w`` (B, n) at the pivots ``y`` (B,)."""
    if uses_kernel_weighted(x, w):
        return cp_objective.wcp_partials_batched(x, w, y)
    return ref.wcp_partials_batched_ref(x, w, y)


def fused_weighted_histogram_batched(x: torch.Tensor, w: torch.Tensor,
                                     edges: torch.Tensor, *,
                                     want_sums: bool = False,
                                     full_bracket: bool = False):
    """Row-wise weighted binned pass: ``x``/``w`` (B, n), per-row realized
    edges ``(B, nbins+1)`` -> ``(cnt, wcnt, wsum)``, each
    ``(B, nbins + 2)``; ``wsum`` (the per-slot sums of ``w*x``) only with
    ``want_sums``, else ``None``.  ``full_bracket`` as in
    :func:`fused_histogram_batched`."""
    if uses_kernel_weighted(x, w):
        return cp_objective.wcp_histogram_batched(
            x, w, edges, want_sums=want_sums, full_bracket=full_bracket)
    return ref.wcp_histogram_batched_ref(x, w, edges, want_sums=want_sums)


def fused_weighted_partials_multi(x: torch.Tensor, w: torch.Tensor,
                                  y: torch.Tensor):
    """The six weighted partials of one shared ``x``/``w`` (n,) at each of
    the pivots ``y`` (K,)."""
    if uses_kernel_weighted(x, w):
        return cp_objective.wcp_partials_multi(x, w, y)
    return ref.wcp_partials_multi_ref(x, w, y)


def fused_weighted_histogram_multi(x: torch.Tensor, w: torch.Tensor,
                                   edges: torch.Tensor, *,
                                   want_sums: bool = False):
    """Shared-x weighted binned pass: ``x``/``w`` (n,) against K realized
    ladders ``(K, nbins+1)`` -> ``(cnt, wcnt, wsum)``, each
    ``(K, nbins + 2)``, ``wsum`` as in
    :func:`fused_weighted_histogram_batched`."""
    if uses_kernel_weighted(x, w):
        return cp_objective.wcp_histogram_multi(x, w, edges,
                                                want_sums=want_sums)
    return ref.wcp_histogram_multi_ref(x, w, edges, want_sums=want_sums)


def fused_weighted_partials(x: torch.Tensor, w: torch.Tensor, y):
    """The K=1 view of :func:`fused_weighted_partials_multi`: a scalar
    pivot."""
    if uses_kernel_weighted(x, w):
        return cp_objective.wcp_partials(x, w, y)
    return ref.wcp_partials_ref(x, w, y)


def fused_weighted_histogram(x: torch.Tensor, w: torch.Tensor,
                             edges: torch.Tensor, *, want_sums: bool = False):
    """The K=1 view of :func:`fused_weighted_histogram_multi`: one ladder
    ``(nbins+1,)`` -> ``(cnt, wcnt, wsum)``, each ``(nbins + 2,)``."""
    if uses_kernel_weighted(x, w):
        return cp_objective.wcp_histogram(x, w, edges, want_sums=want_sums)
    return ref.wcp_histogram_ref(x, w, edges, want_sums=want_sums)
