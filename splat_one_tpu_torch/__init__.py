"""PyTorch/CUDA port of splat_one_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``core``, ``ops``, ``render``, ``data``,
``train``, ``app``) so each module has a counterpart at the same relative
path. It imports torch and numpy only: never ``jax`` and never
``splat_one_tpu``. The CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``utils.cuda_build``).

Convenience imports (submodules stay lazily importable on their own)::

    from splat_one_tpu_torch import rasterization          # gsplat-style renderer
    from splat_one_tpu_torch import Trainer, Config        # train/trainer.py, train/config.py
"""


def __getattr__(name):
    # lazy top-level conveniences without forcing heavy imports at package load
    if name == "rasterization":
        from splat_one_tpu_torch.render.rasterization import rasterization

        return rasterization
    if name == "Trainer":
        from splat_one_tpu_torch.train.trainer import Trainer

        return Trainer
    if name == "Config":
        from splat_one_tpu_torch.train.config import Config

        return Config
    raise AttributeError(f"module 'splat_one_tpu_torch' has no attribute {name!r}")
