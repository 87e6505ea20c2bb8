"""Port parity: Trainer(raster_impl="tiled") against the JAX Trainer's tiled run.

Both Trainers train on the port's synthetic scene (``make_synthetic_scene``
on the CPU: 400 GT gaussians, six 64x64 views, SfM-style init from 200
points, capacity 512, SH degree 1), densification off, the same seeded
batch order, through the gen-1 tiled rasterizer: the same ``IsectCaps``,
and the loss of each of 6 steps within 1e-3 relative (the bar
test_torch_trainer.py holds the stream Trainers to). A port run with a
refine, a capacity doubling and an eval keeps ``IsectCaps`` and renders
through its checkpoint.
"""

import json

import numpy as np
import pytest
import torch

from splat_one_tpu.train.config import Config as JConfig
from splat_one_tpu.train.strategy import DefaultStrategyCfg as JDefault
from splat_one_tpu.train.trainer import SceneData as JSceneData
from splat_one_tpu.train.trainer import Trainer as JTrainer
from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
from splat_one_tpu_torch.ops.intersect import IsectCaps
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg
from splat_one_tpu_torch.train.trainer import Trainer

OFF = dict(refine_start_iter=10_000, refine_stop_iter=10_001,
           refine_every=10_000, reset_every=10_000)
BASE = dict(max_steps=6, eval_steps=[], save_steps=[], sh_degree=1,
            sh_degree_interval=3, capacity=512, camera_model="pinhole",
            test_every=6, batch_size=1, raster_impl="tiled")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    s, _ = make_synthetic_scene(n_gaussians=400, n_cameras=6, width=64, height=64,
                                n_points=200, device="cpu")
    return s


def test_tiled_trainer_tracks_jax(scene, tmp_path):
    jt = JTrainer(JConfig(result_dir=str(tmp_path / "j"), strategy=JDefault(**OFF), **BASE),
                  JSceneData(*scene))
    tt = Trainer(Config(result_dir=str(tmp_path / "t"), strategy=DefaultStrategyCfg(**OFF),
                        **BASE), scene, device="cpu")
    assert isinstance(tt.caps, IsectCaps)
    assert (tt.caps.exp_cap, tt.caps.align_cap) == (jt.caps.exp_cap, jt.caps.align_cap)
    h_j = jt.train(log_every=1)
    h_t = tt.train(log_every=1)
    l_j = np.array([h["loss"] for h in h_j])
    assert len(l_j) == 6 and np.isfinite(l_j).all()
    np.testing.assert_allclose([h["loss"] for h in h_t], l_j, rtol=1e-3)
    assert all(h["overflow"] == 0 for h in h_t)


def test_tiled_trainer_densifies(scene, tmp_path):
    cfg = Config(result_dir=str(tmp_path), sh_degree=1, sh_degree_interval=2,
                 capacity=256, camera_model="pinhole", test_every=6, raster_impl="tiled",
                 max_steps=6, eval_steps=[6], save_steps=[6], tb_every=6,
                 strategy=DefaultStrategyCfg(refine_start_iter=2, refine_stop_iter=100,
                                             refine_every=3, reset_every=5,
                                             grow_grad2d=1e-8))
    tr = Trainer(cfg, scene, device="cpu")
    n0 = int(tr.state.alive.sum())
    hist = tr.train(log_every=1)
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert int(tr.state.alive.sum()) > n0 and tr.capacity >= 512
    assert isinstance(tr.caps, IsectCaps)
    assert tr.caps == IsectCaps.choose(tr.capacity, 1, 16)
    with open(tmp_path / "stats" / "val_step0006.json") as f:
        assert json.load(f)["psnr"] > 5
    tr2 = Trainer(cfg, scene, device="cpu")
    tr2.load_checkpoint(str(tmp_path / "ckpts" / "ckpt_6.npz"))
    assert tr2.caps == tr.caps
    rgb, depth = tr.render_view(scene.camtoworlds[1], scene.Ks[1])
    rgb2, _ = tr2.render_view(scene.camtoworlds[1], scene.Ks[1])
    assert rgb.shape == (64, 64, 3) and np.isfinite(depth).all()
    np.testing.assert_array_equal(rgb, rgb2)
