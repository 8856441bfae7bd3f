"""The port's default device: the card, never a silent fall-back."""
from __future__ import annotations

import torch


def resolve(device, what: str) -> torch.device:
    """``device``, or ``cuda`` when it is ``None``.

    ``None`` raises when no GPU is present: the CPU must be asked for by
    name (``device="cpu"``).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what} places data on the GPU by default "
                               "and no CUDA device is available; pass "
                               "device='cpu' to compute on the CPU")
        device = "cuda"
    return torch.device(device)
