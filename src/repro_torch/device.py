"""Device resolution for the port's entry points.

Every entry point computes on the CUDA card unless its caller asks for the
CPU by name (``device="cpu"``), as the CPU tests do. Without a card the
default raises instead of quietly running elsewhere.
"""

from __future__ import annotations

import numpy as np
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


def on_device(device, arrays, dtypes, contiguous: bool = True):
    """Move ``arrays`` (tensors or numpy arrays) to one device: that of the
    tensors among them, else ``resolve_device(device)``. Each becomes a
    tensor of its entry in ``dtypes`` (``None`` keeps its dtype), made
    contiguous unless ``contiguous`` is false.
    Raises ``ValueError`` when the tensors lie on several devices or
    ``device`` names another kind of device than theirs."""
    devs = {a.device for a in arrays if isinstance(a, torch.Tensor)}
    if len(devs) > 1:
        raise ValueError(f"inputs lie on several devices: "
                         f"{sorted(map(str, devs))}")
    if devs:
        dev = devs.pop()
        if device is not None and torch.device(device).type != dev.type:
            raise ValueError(f"device={device!r} but the inputs lie on {dev}")
    else:
        dev = resolve_device(device)

    def conv(a, dtype):
        t = a if isinstance(a, torch.Tensor) \
            else torch.as_tensor(np.asarray(a))
        t = t.to(device=dev, dtype=dtype)
        return t.contiguous() if contiguous else t

    return [conv(a, dtype) for a, dtype in zip(arrays, dtypes)]
