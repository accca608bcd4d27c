"""Device choice for the port's entry points.

They run on ``cuda`` unless the caller asks for the CPU. Without a CUDA
device and without that request they raise: a server or a benchmark that
meant to use the card must not quietly run on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``; raise if the requested CUDA device is
    missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the host")
    return dev
