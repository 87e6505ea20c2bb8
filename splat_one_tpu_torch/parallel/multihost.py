"""Multi-process runtime entry: one process per GPU.

Counterpart of ``splat_one_tpu/parallel/multihost.py``. Under ``torchrun
--nproc-per-node N`` (or any launcher that sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``) every process calls

    from splat_one_tpu_torch.parallel import multihost
    multihost.initialize()
    mesh = multihost.global_mesh(n_data=..., n_gauss=...)
    trainer = Trainer(cfg, scene, mesh=mesh)

and runs the same training loop; rank ``r`` works on ``cuda:LOCAL_RANK``.
The process group's backend follows the device: NCCL for CUDA, gloo for
the CPU.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from splat_one_tpu_torch.parallel.train_step import Mesh, make_mesh
from splat_one_tpu_torch.utils.device import rank_device

# this process's node-local rank, set by initialize()
_local_rank = 0


def _env_int(name: str, value: Optional[int], default: int) -> int:
    if value is not None:
        return int(value)
    return int(os.environ.get(name, default))


def initialize(rank: Optional[int] = None, world_size: Optional[int] = None,
               local_rank: Optional[int] = None, master_addr: Optional[str] = None,
               master_port: Optional[int] = None, *, device="cuda",
               init_method: Optional[str] = None, timeout_s: float = 600.0) -> None:
    """Start this process's ``torch.distributed`` process group.

    Arguments default to torchrun's environment variables. Idempotent, and
    a no-op in a single process (no ``MASTER_ADDR`` and no
    ``init_method``), so single-GPU scripts may call it unconditionally.
    ``init_method`` (e.g. ``file://...``) replaces the TCP rendezvous at
    ``master_addr:master_port``. On CUDA the process binds
    ``cuda:local_rank`` first; raises where it sees no such card."""
    global _local_rank
    if dist.is_initialized():
        return
    master_addr = master_addr or os.environ.get("MASTER_ADDR")
    if init_method is None:
        if master_addr is None:
            return  # a single process
        port = _env_int("MASTER_PORT", master_port, 29500)
        init_method = f"tcp://{master_addr}:{port}"
    rank = _env_int("RANK", rank, 0)
    world_size = _env_int("WORLD_SIZE", world_size, 1)
    local_rank = _env_int("LOCAL_RANK", local_rank, rank)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, rank=rank, world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _local_rank = local_rank


def global_mesh(n_data: int, n_gauss: int, device="cuda") -> Mesh:
    """The (data, gauss) mesh over every process of the world, on this
    process's device (``cuda:LOCAL_RANK`` for CUDA): the gauss axis over
    consecutive ranks, so its per-step exchange of projected fields stays
    among the GPUs of one node when a node holds ``n_gauss`` of them."""
    return make_mesh(n_data, n_gauss, rank_device(device, _local_rank))


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that writes checkpoints, stats and logs."""
    return not dist.is_initialized() or dist.get_rank() == 0
