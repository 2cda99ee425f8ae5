"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; it raises when CUDA is absent rather
    than dropping to the CPU.  Any explicit device is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "tensor code on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
