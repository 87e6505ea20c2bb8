"""The (data, gauss) mesh of multi-GPU training.

Counterpart of ``splat_one_tpu/parallel/train_step.py``, on
``torch.distributed`` with one process per rank. The JAX package's 2-D
device mesh becomes this rank's place in an ``n_data x n_gauss`` grid of
ranks, laid out row-major as JAX lays out its devices (rank =
``d * n_gauss + g``, the gauss axis on consecutive local ranks), with a
process group along each axis:
  - ``data``: camera batches are split over it; parameter gradients are
    averaged across it;
  - ``gauss``: the splat buffers (and their Adam moments, strategy state
    and alive mask) are split over it on the capacity axis, and every
    rank composites one supertile slab of the image.
The mesh-aware step is ``train.trainer.Trainer(mesh=...)``; the
standalone shardings are ``parallel.tile_sharded`` and
``parallel.ring_sharded``; ``parallel.multihost`` starts the process
group.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the (data, gauss) mesh and its two groups:
    ``gauss_group`` holds the ranks ``d * n_gauss + 0 .. n_gauss - 1``,
    ``data_group`` the ranks ``g, n_gauss + g, ...``."""

    shape: Dict[str, int]  # {"data": n_data, "gauss": n_gauss}
    d: int  # this rank's data index
    g: int  # this rank's gauss index
    gauss_group: Any
    data_group: Any
    device: torch.device

    @property
    def rank(self) -> int:
        return self.d * self.shape["gauss"] + self.g


def make_mesh(n_data: int, n_gauss: int, device) -> Mesh:
    """The mesh of an initialised process group of ``n_data * n_gauss``
    ranks, on this rank's ``device``. Every rank makes every group, in
    the same order. Raises unless the world has that many ranks and its
    backend fits the device (NCCL for CUDA, gloo for the CPU)."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.multihost.initialize() "
                           "(or torch.distributed.init_process_group) first")
    device = torch.device(device)
    world = dist.get_world_size()
    if world != n_data * n_gauss:
        raise ValueError(f"a {n_data} x {n_gauss} mesh needs {n_data * n_gauss} ranks, "
                         f"the world has {world}")
    backend = dist.get_backend()
    want = "nccl" if device.type == "cuda" else "gloo"
    if backend != want:
        raise RuntimeError(f"a {device.type} mesh needs the {want} backend, the process "
                           f"group uses {backend}")
    rank = dist.get_rank()
    d, g = divmod(rank, n_gauss)
    gauss_groups = [dist.new_group([dd * n_gauss + j for j in range(n_gauss)])
                    for dd in range(n_data)]
    data_groups = [dist.new_group([j * n_gauss + gg for j in range(n_data)])
                   for gg in range(n_gauss)]
    return Mesh(shape={"data": n_data, "gauss": n_gauss}, d=d, g=g,
                gauss_group=gauss_groups[d], data_group=data_groups[g], device=device)
