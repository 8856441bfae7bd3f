"""Monotone transform guard for extreme-valued data (paper Sec. V-D).

Order statistics are invariant under strictly increasing maps.  For data with
components of order 1e20, summation in (1) loses the small terms; the paper
applies ``F(t) = log(1 + t - x_(1))`` and selects in the transformed domain.
We run the *iterations* on ``F(x)`` and the exact finalize on the original
values (bracket mapped back and widened by one ulp on each side).
"""
from __future__ import annotations

import torch


def next_float(y: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(y, torch.full_like(y, float("inf")))


def prev_float(y: torch.Tensor) -> torch.Tensor:
    return torch.nextafter(y, torch.full_like(y, float("-inf")))


def log1p_transform(x: torch.Tensor):
    """Returns (F(x), F_inverse). F(t) = log1p(t - min(x)) — strictly
    increasing on [min(x), inf), maps the data into a well-conditioned range.
    """
    x0 = torch.min(x)

    def inverse(y):
        return torch.expm1(y) + x0

    return torch.log1p(x - x0), inverse


def log1p_transform_rows(x: torch.Tensor) -> torch.Tensor:
    """Row-wise monotone guard for the batched engine: ``x`` is (B, n) and
    each row gets its own anchor ``F_i(t) = log1p(t - min(x_i))``.  Only the
    forward image is needed — the batched finalize maps brackets back by
    count-preserving preimage reductions, never by the float inverse (see
    ``selection._map_bracket_back_rows``)."""
    return torch.log1p(x - torch.amin(x, dim=1, keepdim=True))
