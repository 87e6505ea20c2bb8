"""Port parity: data/synthetic.make_synthetic_scene against the JAX package.

Both render ground truth through their ``impl="tiled"`` rasterizer with
``IsectCaps.choose`` defaults, one camera at a time. At a small size
(300 gaussians, 3 cameras, 48x32) for the ring, the three-ring surface and
the spherical camera sets: images within 1e-5, every other field of the
SceneData and the GT parameters exactly equal.
"""

import numpy as np
import pytest
import torch

from splat_one_tpu.data.synthetic import make_synthetic_scene as jmake
from splat_one_tpu_torch.data.synthetic import make_synthetic_scene as tmake
from splat_one_tpu_torch.train.trainer import SceneData


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("variant", ["ring", "surface", "spherical"])
def test_make_synthetic_scene_matches_jax(variant):
    kw = dict(n_gaussians=300, n_cameras=3, width=48, height=32, n_points=100, seed=1,
              camera_model="spherical" if variant == "spherical" else "pinhole",
              surface=(variant == "surface"))
    sj, gj = jmake(**kw)
    st, gt = tmake(**kw, device="cpu")
    assert isinstance(st, SceneData)
    assert st.images.shape == sj.images.shape == (3, 32, 48, 3)
    assert st.images.dtype == np.float32
    assert np.abs(st.images - sj.images).max() <= 1e-5
    assert st.images.max() > 0.2  # the GT is not empty
    for f in ("camtoworlds", "Ks", "points", "points_rgb"):
        np.testing.assert_array_equal(getattr(st, f), getattr(sj, f), err_msg=f)
    assert st.scene_scale == sj.scene_scale and st.camera_model == sj.camera_model
    assert sorted(gt) == sorted(gj)
    for k in gj:
        np.testing.assert_array_equal(gt[k], gj[k], err_msg=k)


def test_make_synthetic_scene_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmake(n_gaussians=10, n_cameras=1, width=16, height=16)
