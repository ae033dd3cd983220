"""Where the port's entry points run: ``cuda`` unless the caller asks for
``cpu``, and never anywhere else without being asked."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises for CUDA when no card is present
    rather than running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' was requested but torch.cuda.is_available() is "
            "false; pass device='cpu' (--device cpu) to run on the CPU")
    return dev
