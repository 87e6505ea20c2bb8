"""The port's device rule: entry points run on CUDA unless the caller
passes ``device="cpu"``; asking for CUDA where there is none raises. A
rank of a multi-GPU world runs on ``cuda:LOCAL_RANK`` (``rank_device``)."""

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


def rank_device(device, local_rank: int) -> torch.device:
    """The device of the rank with node-local index ``local_rank``:
    ``cuda:local_rank`` for a CUDA ``device`` (raises where this node sees
    fewer cards than that needs), the CPU for a CPU one."""
    dev = resolve(device)
    if dev.type != "cuda":
        return dev
    n = torch.cuda.device_count()
    if local_rank >= n:
        raise RuntimeError(f"local rank {local_rank} needs cuda:{local_rank}, but this "
                           f"process sees {n} CUDA device(s)")
    return torch.device("cuda", local_rank)
