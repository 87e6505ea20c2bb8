"""PyTorch/CUDA port of splat_one_tpu for NVIDIA Hopper.

Mirrors the JAX package's layout (``core``, ``ops``, ``render``, ``data``,
``train``, ``app``) so each module has a counterpart at the same relative
path. It imports torch and numpy only: never ``jax`` and never
``splat_one_tpu``. The CUDA kernels live in ``csrc/`` and are built with
``nvcc`` at first use (``utils.cuda_build``).
"""
