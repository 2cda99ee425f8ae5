"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` (or ``"cuda"``, a command line's ``--device`` default)
    means the CUDA card; it raises when CUDA is absent rather than dropping
    to the CPU.  Any other device is taken as given."""
    if device is None or device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "tensor code on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
