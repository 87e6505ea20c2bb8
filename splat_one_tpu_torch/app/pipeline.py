"""Workdir pipeline stages: counterpart of ``splat_one_tpu/app/pipeline.py``.

The port has the train stage: ``reconstruction.json`` + ``images/`` in a
workdir -> a trained (or, with ``Config.ckpt``, evaluated) splat model
under ``<workdir>/results``. The SfM stages (``extract_metadata`` to
``reconstruct``) come with Slice F, ``create_masks`` and
``estimate_depth`` with Slice G.
"""

from __future__ import annotations

import os
from typing import Optional

from splat_one_tpu_torch.data.opensfm import Parser, to_scene_data
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.trainer import Trainer
from splat_one_tpu_torch.utils.device import resolve as resolve_device


def train_splats(workdir: str, cfg: Optional[Config] = None,
                 max_images: Optional[int] = None, device="cuda"):
    """Parse the workdir's OpenSfM reconstruction (factor 1, as the JAX
    stage does whatever ``Config.data_factor`` says), load its images and
    ``Trainer.run`` with results under ``<workdir>/results``. Returns
    ``(trainer, history)``: the training history, or the eval stats when
    ``cfg.ckpt`` is set. Runs on CUDA unless ``device="cpu"``."""
    dev = resolve_device(device)
    parser = Parser(workdir)
    scene = to_scene_data(parser, max_images=max_images)
    cfg = cfg or Config()
    cfg.result_dir = os.path.join(workdir, "results")
    cfg.camera_model = scene.camera_model
    trainer = Trainer(cfg, scene, device=dev)
    return trainer, trainer.run()
