"""The port's device rule: entry points run on CUDA unless the caller
passes ``device="cpu"``; asking for CUDA where there is none raises."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is CUDA and CUDA is
    not available (no silent fall back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: pass device='cpu' to run on the CPU")
    return dev
