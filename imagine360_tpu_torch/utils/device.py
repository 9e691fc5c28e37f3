"""The device an entry point runs on: the card unless the caller asks for
the CPU."""
from __future__ import annotations

import torch


def require_device(device="cuda") -> torch.device:
    """`device` as a torch.device. A CUDA device that is not there raises:
    nothing falls back to the CPU on its own; the CPU is used only when
    asked for (`device="cpu"`)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' to run on the CPU")
    return dev
