"""Port parity: ``models/depth_tpu.py`` against the JAX package, on the CPU.

Both packages run the same weights: a random mini Depth-Anything-V2 state
dict in the published layout (``tests/test_weight_converters.py``'s
schema: width 32, 4 blocks, 2 heads, 16 features, a 4x4 position grid)
converted by ``scripts/convert_weights.py``'s ``convert_depth`` (called,
not edited), and JAX's compact ``init_depth_model`` parameters carried
across as numpy. The mini configurations are added to both packages'
``CONFIGS`` for the module. JAX runs under ``jax.jit``.

- ``depth_forward_faithful`` at 56x56 and at 70x84 (its position grid
  resized with aligned corners): within 1e-4 of the output's largest
  entry.
- ``depth_forward`` (the compact tier, 4 blocks of width 32 at 518x518):
  within 1e-5 of the output's largest entry.
- ``infer_image``, ``infer_equirectangular`` and ``infer_fisheye`` of
  ``DepthAnythingTPU`` on the mini checkpoint: within 1e-4 of JAX's
  largest entry.
- The contracts of ``tests/test_models.py``'s ``TestDepth`` on the port:
  the seeded compact vits without weights (shape, finite, normalised),
  the fisheye round trip and the full-frame fisheye without warnings
  (the network stubbed to return the red channel), ``save_depth_outputs``
  writing JAX's bytes.
"""

import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "scripts")

from convert_weights import convert_depth  # noqa: E402
from splat_one_tpu.models import depth_tpu as JD  # noqa: E402
from splat_one_tpu_torch.models import depth_tpu as TD  # noqa: E402
from test_weight_converters import _torch_dav2_sd  # noqa: E402

MINI = dict(width=32, depth=4, heads=2, features=16)


@pytest.fixture(autouse=True, scope="module")
def _mini_configs():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        for cfgs in (JD.CONFIGS, TD.CONFIGS):
            mp.setitem(cfgs, "mini", MINI)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("dav2")
    torch.save(_torch_dav2_sd(np.random.default_rng(0), C=32, D=4, heads=2, F=16),
               d / "mini.pth")
    out = d / "mini.npz"
    convert_depth(str(d / "mini.pth"), "mini", str(out))
    return str(out)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.mark.parametrize("hw", [(56, 56), (70, 84)])
def test_faithful_forward_matches_jax(ckpt, hw):
    with np.load(ckpt) as z:
        npz = {k: z[k] for k in z.files}
    assert str(npz["_encoder"]) == "mini"
    pt = TD.params_from_numpy(npz, "cpu")
    assert pt["_encoder"] == "mini"
    pj = {k: jnp.asarray(v) for k, v in npz.items() if k != "_encoder"}
    x = np.random.default_rng(1).normal(scale=0.7, size=(1, *hw, 3)).astype(np.float32)
    fj = jax.jit(lambda p, im: JD.depth_forward_faithful(dict(p, _encoder="mini"), im))
    want = np.asarray(fj(pj, jnp.asarray(x)))
    got = TD.depth_forward_faithful(pt, torch.as_tensor(x)).numpy()
    assert got.shape == (1, *hw) and np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-4


def test_resize_ac_matches_jax():
    x = np.random.default_rng(2).normal(size=(1, 4, 5, 3)).astype(np.float32)
    for oh, ow in ((37, 37), (1, 9), (4, 5), (8, 10)):
        want = np.asarray(JD._resize_ac(jnp.asarray(x), oh, ow))
        np.testing.assert_allclose(TD._resize_ac(torch.as_tensor(x), oh, ow).numpy(), want,
                                   rtol=0, atol=1e-6)


def test_compact_forward_matches_jax():
    # key 3: every output pixel positive (under keys 0-2 the final ReLU
    # zeroes all or most of them, which would compare little)
    pj = JD.init_depth_model(jax.random.PRNGKey(3), "mini")
    npz = {k: (v if k == "_encoder" else np.asarray(v)) for k, v in pj.items()}
    pt = TD.params_from_numpy(npz, "cpu")
    x = np.random.default_rng(3).uniform(size=(1, TD.IMG, TD.IMG, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, im: JD.depth_forward(dict(p, _encoder="mini"), im))(
        {k: v for k, v in pj.items() if k != "_encoder"}, jnp.asarray(x)))
    got = TD.depth_forward(pt, torch.as_tensor(x)).numpy()
    assert got.shape == (1, 74, 74) and np.abs(want).max() > 0
    assert _rel(got, want) <= 1e-5
    # the seeded init has JAX's keys and shapes
    init = TD.init_depth_model(torch.Generator().manual_seed(0), "mini")
    assert {k: tuple(v.shape) for k, v in init.items() if k != "_encoder"} == {
        k: v.shape for k, v in pj.items() if k != "_encoder"}


@pytest.fixture(scope="module")
def models(ckpt):
    mj = JD.DepthAnythingTPU("mini", checkpoint=ckpt)
    mt = TD.DepthAnythingTPU("mini", checkpoint=ckpt, device="cpu")
    assert mj._faithful and mt._faithful and mt.has_weights
    return mj, mt


def test_infer_paths_match_jax(models):
    mj, mt = models
    rng = np.random.default_rng(4)
    bgr = (rng.uniform(size=(90, 120, 3)) * 255).astype(np.uint8)
    got, want = mt.infer_image(bgr), mj.infer_image(bgr)
    assert got.shape == (90, 120) and got.dtype == np.float32
    assert _rel(got, want) <= 1e-4
    pano = (rng.uniform(size=(64, 128, 3)) * 255).astype(np.uint8)
    assert _rel(mt.infer_equirectangular(pano), mj.infer_equirectangular(pano)) <= 1e-4
    K = np.array([[40.0, 0, 61], [0, 40.0, 44], [0, 0, 1]], np.float32)
    dist = np.array([0.03, -0.01, 0.0, 0.0])
    got = mt.infer_fisheye(bgr, K, dist=dist)
    assert got.shape == (90, 120)
    assert _rel(got, mj.infer_fisheye(bgr, K, dist=dist)) <= 1e-4


def test_compact_vits_contract():
    model = TD.DepthAnythingTPU("vits", device="cpu")
    bgr = (np.random.default_rng(0).uniform(size=(120, 160, 3)) * 255).astype(np.uint8)
    d = model.infer_image(bgr)
    assert d.shape == (120, 160) and np.isfinite(d).all() and not model.has_weights
    assert d.min() == 0.0 and d.max() == 1.0


def _red_stub():
    model = TD.DepthAnythingTPU("mini", device="cpu")
    model.infer_image = lambda bgr: bgr[..., 2].astype(np.float32) / 255.0
    return model


def test_fisheye_roundtrip():
    """tests/test_models.py's round trip on the port: the network stubbed
    to return the ERP red channel, the output reproduces the input's red
    channel inside the FOV and is 0 outside it."""
    model = _red_stub()
    H = W = 160
    f = W / np.pi
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    red = 0.5 + 0.4 * np.sin(xx / 11.0) * np.cos(yy / 13.0)
    bgr = np.zeros((H, W, 3), np.uint8)
    bgr[..., 2] = (red * 255).astype(np.uint8)
    out = model.infer_fisheye(bgr, K, dist=np.array([0.03, -0.01, 0.0, 0.0]), fov_deg=170.0,
                              erp_size=256)
    assert out.shape == (H, W)
    r = np.hypot(xx - W / 2, yy - H / 2)
    err = np.abs(out[r < 0.32 * W] - red[r < 0.32 * W])
    assert np.median(err) < 0.02 and err.mean() < 0.04
    assert (out[r > 0.52 * W] == 0).all()


def test_fisheye_full_frame_no_warnings():
    model = _red_stub()
    H, W, f = 120, 240, 50.0
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    yy, xx = np.mgrid[0:H, 0:W]
    red = 0.5 + 0.4 * np.sin(xx / 9.0) * np.cos(yy / 12.0)
    bgr = np.zeros((H, W, 3), np.uint8)
    bgr[..., 2] = (red * 255).astype(np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        out = model.infer_fisheye(bgr, K, dist=np.array([0.05, -0.02, 0.01, 0.0]),
                                  fov_deg=170.0, erp_size=256)
    assert np.isfinite(out).all()
    r = np.hypot(xx - W / 2, yy - H / 2)
    assert np.median(np.abs(out[r < 0.5 * f] - red[r < 0.5 * f])) < 0.02
    assert (out[r > 2.0 * f] == 0).all()


def test_save_depth_outputs_bytes(tmp_path):
    d = np.random.default_rng(0).uniform(size=(32, 40)).astype(np.float32)
    JD.save_depth_outputs(d, str(tmp_path / "j"), "img1")
    TD.save_depth_outputs(d, str(tmp_path / "t"), "img1")
    for f in ("img1_depth.npy", "img1_depth.png"):
        assert (tmp_path / "t" / f).read_bytes() == (tmp_path / "j" / f).read_bytes()
