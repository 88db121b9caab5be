"""Where the port's entry points run: the GPU unless the caller names another
device.  Imports only torch, so that every layer can depend on it."""

from __future__ import annotations

import torch


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` means the GPU, and fails where there is none: the CPU is
    used only when the caller names it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device found: this package runs on the GPU unless "
                "the caller asks for another device (device='cpu')"
            )
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
