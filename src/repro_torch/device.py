"""Device selection shared by every entry point of the port.

Entry points run on the GPU unless the caller asks for the CPU.  There
is no silent fallback: with no CUDA device and no explicit ``"cpu"``,
:func:`resolve_device` raises.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda`` (raises when no GPU is visible); anything else
    is taken as given (``"cpu"`` selects the plain PyTorch path)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is visible; pass device='cpu' to run the "
                "plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not available")
    return dev
