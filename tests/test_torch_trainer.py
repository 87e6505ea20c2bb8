"""Port parity: the single-device Trainer against the JAX Trainer.

Both Trainers train on one JAX-made synthetic scene (400 GT gaussians,
six 64x64 views, SfM-style init from 200 points, capacity 512, SH degree
1 ramped at step 10), densification off, the same seeded batch order.

- After step 1, every parameter within 5e-4 relative of its max (the
  gradient bar of the rasterizer paths). Quaternions are compared through
  the covariance R diag(s^2) R^T they produce: the init gaussians are
  isotropic, so their quaternion gradient is zero up to rounding, and
  Adam's first step (lr * sign(g)) turns rounding-level gradients of
  either sign into +-lr; the covariance, which is what renders, does not
  depend on those quaternions.
- The loss of each of 10 steps within 1e-3 relative.
- A JAX checkpoint (npz) resumes in the port: the state loads exactly and
  the resumed run's losses track the JAX run's.
The port's own Trainer: densification changes the alive count within its
capacity, the opacity reset runs, eval reports psnr / ssim and lpips
None, its checkpoint renders through ``app.viewer``, and what is not
ported is refused.
"""

import json
import os

import numpy as np
import pytest
import torch

from splat_one_tpu.data.synthetic import make_synthetic_scene
from splat_one_tpu.train.config import Config as JConfig
from splat_one_tpu.train.strategy import DefaultStrategyCfg as JDefault
from splat_one_tpu.train.trainer import Trainer as JTrainer
from splat_one_tpu_torch.app import viewer
from splat_one_tpu_torch.core.transforms import quat_to_rotmat
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg, MCMCStrategyCfg
from splat_one_tpu_torch.train.trainer import SceneData, Trainer

OFF = dict(refine_start_iter=10_000, refine_stop_iter=10_001,
           refine_every=10_000, reset_every=10_000)
BASE = dict(max_steps=10, eval_steps=[], save_steps=[], sh_degree=1,
            sh_degree_interval=10, capacity=512, camera_model="pinhole",
            test_every=6, batch_size=1)

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small ops, which
    gain nothing from threads, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def scene():
    s, _ = make_synthetic_scene(n_gaussians=400, n_cameras=6, width=64,
                                height=64, n_points=200)
    return s


def _stop_after(n):
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > n

    return stop


def _cov(p):
    R = quat_to_rotmat(p["quats"])
    s2 = torch.exp(2.0 * p["scales"])
    return torch.einsum("nij,nj,nkj->nik", R, s2, R)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def test_trainer_tracks_jax(scene, tmp_path):
    jt = JTrainer(JConfig(result_dir=str(tmp_path / "j"), strategy=JDefault(**OFF),
                          **BASE), scene)
    tt = Trainer(Config(result_dir=str(tmp_path / "t"), strategy=DefaultStrategyCfg(**OFF),
                        **BASE), SceneData(*scene), device="cpu")
    np.testing.assert_array_equal(tt.val_idx, jt.val_idx)
    assert (tt.caps.exp_cap, tt.caps.pad_cap) == (jt.caps.exp_cap, jt.caps.pad_cap)
    h_j = jt.train(log_every=1, stop_flag=_stop_after(1))
    h_t = tt.train(log_every=1, stop_flag=_stop_after(1))
    assert tt.state.step == int(jt.state.step) == 1
    pj = {k: np.asarray(v) for k, v in jt.state.params.items()}
    for k, v in tt.state.params.items():
        if k != "quats":
            assert _rel(v.numpy(), pj[k]) < 5e-4, k
    cov_j = _cov({k: torch.tensor(v) for k, v in pj.items()})
    assert _rel(_cov(tt.state.params).numpy(), cov_j.numpy()) < 5e-4

    # the JAX checkpoint of step 1 resumes in a fresh port Trainer
    ckpt = jt.save_checkpoint(1)
    tr = Trainer(Config(result_dir=str(tmp_path / "r"), strategy=DefaultStrategyCfg(**OFF),
                        **BASE), SceneData(*scene), device="cpu")
    tr.load_checkpoint(ckpt)
    assert tr.state.step == 1
    for k, v in tr.state.params.items():
        np.testing.assert_array_equal(v.numpy(), pj[k])
    np.testing.assert_array_equal(tr.state.opt_state.m["means"].numpy(),
                                  np.asarray(jt.state.opt_state.m["means"]))

    h_j += jt.train(log_every=1)
    h_t += tt.train(log_every=1)
    h_r = tr.train(log_every=1)
    l_j = np.array([h["loss"] for h in h_j])
    assert len(l_j) == 10 and np.isfinite(l_j).all()
    np.testing.assert_allclose([h["loss"] for h in h_t], l_j, rtol=1e-3)
    np.testing.assert_allclose([h["loss"] for h in h_r], l_j[1:], rtol=1e-3)
    assert [h["num_GS"] for h in h_t] == [h["num_GS"] for h in h_j]


def test_trainer_densifies_and_checkpoints(scene, tmp_path):
    cfg = Config(result_dir=str(tmp_path), sh_degree=1, sh_degree_interval=2,
                 capacity=256, camera_model="pinhole", test_every=6,
                 max_steps=8, eval_steps=[8], save_steps=[8], tb_every=4,
                 strategy=DefaultStrategyCfg(refine_start_iter=2, refine_stop_iter=100,
                                             refine_every=3, reset_every=7,
                                             grow_grad2d=1e-8))
    tr = Trainer(cfg, SceneData(*scene), device="cpu")
    n0 = int(tr.state.alive.sum())
    hist = tr.train(log_every=1)
    assert np.isfinite([h["loss"] for h in hist]).all()
    # the refines grew the population past 0.9 of the capacity, so the
    # buffers doubled at least once
    assert int(tr.state.alive.sum()) > n0
    assert tr.capacity >= 512 and tr.state.params["means"].shape[0] == tr.capacity
    assert int(tr.state.alive.sum()) <= tr.capacity
    with open(tmp_path / "stats" / "val_step0008.json") as f:
        stats = json.load(f)
    assert stats["lpips"] is None and stats["psnr"] > 5 and 0 < stats["ssim"] <= 1
    assert any(f.startswith("events.out.tfevents") for f in os.listdir(tmp_path / "tb"))
    ckpt = tmp_path / "ckpts" / "ckpt_8.npz"
    params, alive = viewer.load_checkpoint_params(str(ckpt), device="cpu")
    np.testing.assert_array_equal(alive.numpy(), tr.state.alive.numpy())
    fn = viewer.make_render_fn(params, alive, 64, 64, sh_degree=1, device="cpu")
    rgb_v, depth_v, _, _ = fn.render(scene.camtoworlds[1], scene.Ks[1])
    rgb_t, depth_t = tr.render_view(scene.camtoworlds[1], scene.Ks[1])
    assert rgb_t.shape == (64, 64, 3) and np.isfinite(rgb_t).all()
    np.testing.assert_allclose(np.clip(rgb_v.numpy(), 0, 1), rgb_t, atol=1e-6)
    tr2 = Trainer(cfg, SceneData(*scene), device="cpu")
    tr2.load_checkpoint(str(ckpt))
    assert tr2.capacity == tr.capacity and tr2.state.step == 8


def test_trainer_refuses_what_is_not_ported(scene, tmp_path):
    ok = dict(result_dir=str(tmp_path), capacity=512, camera_model="pinhole")
    for bad in (dict(pose_opt=True), dict(app_opt=True), dict(use_bilateral_grid=True),
                dict(raster_impl="tiled"), dict(strategy=MCMCStrategyCfg())):
        with pytest.raises(NotImplementedError):
            Trainer(Config(**ok, **bad), SceneData(*scene), device="cpu")
    with pytest.raises(NotImplementedError):
        Trainer(Config(**ok), SceneData(*scene), mesh=object(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Trainer(Config(**ok), SceneData(*scene))
