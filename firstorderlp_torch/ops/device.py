"""The one rule for choosing a device, shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device. Raises when no GPU
    is present and no device was asked for: nothing gives way to the
    CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
