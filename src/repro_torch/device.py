"""Device resolution for the port's entry points.

Every entry point computes on the CUDA card unless its caller asks for the
CPU by name (``device="cpu"``), as the CPU tests do. Without a card the
default raises instead of quietly running elsewhere.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current CUDA device; raises ``RuntimeError`` when no
    card is present. ``"cpu"`` (or any explicit device) is taken as given,
    but an explicit CUDA device still needs a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev
