"""Port parity: ``models/aliked_tpu.py`` against the JAX package, on the CPU.

Both packages run the same random weights: JAX's ``init_aliked_ckpt``
(``aliked-t16``) and ``init_aliked`` parameters carried across as numpy
(``params_from_numpy``: HWIO -> OIHW; ``params_to_numpy`` gives them
back bit for bit).

- ``_upsample_bilinear`` (aligned corners, the gather formula) and
  ``_bilinear_sample`` (zero padding, positions inside and outside the
  map) within 1e-6 abs.
- The faithful encoder on a 96x96 RGB image: score map and feature map
  within 1e-5 abs; ``sddh_descriptors`` at given keypoints within 1e-5.
- The compact tier's ``aliked_forward``: score and descriptor maps within
  1e-5 abs.
- ``extract_aliked_ckpt`` (grayscale broadcast to 3 channels, a size
  that pads to 32) and ``extract_aliked`` on the textured sphere: the
  same valid keypoints in the same order (``jax.lax.top_k``'s order),
  ``xys`` within 1e-4 px, descriptors within 1e-4 abs, scores within
  1e-5.
- One ``.npz``, converted by ``scripts/convert_weights.py aliked`` from a
  torch state dict of the published architecture, loads in both
  packages (the faithful tier) and gives the same features; a compact
  tier npz written from JAX's params too. Without a file both fall back
  to their compact initialization with JAX's shapes.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu.models import aliked_tpu as JA
from splat_one_tpu_torch.models import aliked_tpu as TA
from test_app_pipeline import textured_sphere_images


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the SfM test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    c2ws, Ks = ring_cameras(4, 2.0, -0.3, 60.0, 112, 100)
    return [im.astype(np.float32) for im in textured_sphere_images(c2ws[:2], Ks[:2], 112, 100)]


@pytest.fixture(scope="module")
def params():
    pj = jax.jit(JA.init_aliked_ckpt, static_argnums=1)(jax.random.PRNGKey(1), "aliked-t16")
    cj = jax.jit(JA.init_aliked)(jax.random.PRNGKey(0))
    return pj, TA.params_from_numpy({k: np.asarray(v) for k, v in pj.items()}, "cpu"), \
        cj, TA.params_from_numpy({k: np.asarray(v) for k, v in cj.items()}, "cpu")


def _feats_close(fa, fb):
    fa = [np.asarray(x) for x in fa]
    fb = [x.numpy() for x in fb]
    assert [x.shape for x in fa] == [x.shape for x in fb]
    np.testing.assert_array_equal(fb[5], fa[5])
    v = fa[5]
    assert v.sum() >= 20
    assert np.abs(fb[0][v] - fa[0][v]).max() <= 1e-4
    np.testing.assert_array_equal(fb[1], fa[1])
    assert np.abs(fb[3][v] - fa[3][v]).max() <= 1e-4
    assert np.abs(fb[4] - fa[4]).max() <= 1e-5
    assert not fb[3][~v].any()


def test_params_roundtrip_and_init_shapes(params):
    pj, pt, cj, ct = params
    back = TA.params_to_numpy(pt)
    assert set(back) == set(pj)
    for k in pj:
        np.testing.assert_array_equal(back[k], np.asarray(pj[k]))
    for cfg in ("aliked-t16", "aliked-n32"):
        a = jax.eval_shape(lambda: JA.init_aliked_ckpt(jax.random.PRNGKey(0), cfg))
        b = TA.params_to_numpy(TA.init_aliked_ckpt(cfg, device="cpu"))
        assert {k: v.shape for k, v in b.items()} == {k: tuple(v.shape) for k, v in a.items()}
    b = TA.params_to_numpy(TA.init_aliked(96, device="cpu"))
    assert {k: v.shape for k, v in b.items()} == {
        k: tuple(v.shape) for k, v in jax.eval_shape(
            lambda: JA.init_aliked(jax.random.PRNGKey(0), 96)).items()}


def test_upsample_and_bilinear_sample():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 5, 7, 3)).astype(np.float32)
    for out in ((20, 28), (5, 7), (1, 9)):
        a = np.asarray(jax.jit(JA._upsample_bilinear, static_argnums=(1, 2))(
            jnp.asarray(x), 4, out))
        b = TA._upsample_bilinear(torch.as_tensor(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
        assert np.abs(a - b.numpy()).max() <= 1e-6, out
    feat = rng.normal(size=(9, 11, 4)).astype(np.float32)
    pos = rng.uniform(-2, 12, (30, 5, 2)).astype(np.float32)
    a = np.asarray(jax.jit(JA._bilinear_sample)(jnp.asarray(feat), jnp.asarray(pos)))
    b = TA._bilinear_sample(torch.as_tensor(feat), torch.as_tensor(pos)).numpy()
    assert np.abs(a - b).max() <= 1e-6


def test_encoder_sddh_and_compact_forward(params, images):
    pj, pt, cj, ct = params
    rgb = np.stack([images[0][:96, :96]] * 3, -1)[None]
    rgb[..., 1] = images[1][:96, :96]
    sj, fj = jax.jit(JA.aliked_encoder)(pj, jnp.asarray(rgb))
    st, ft = TA.aliked_encoder(pt, torch.as_tensor(rgb))
    assert st.shape == tuple(sj.shape) and ft.shape == tuple(fj.shape) == (1, 96, 96, 64)
    assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-5
    assert np.abs(ft.numpy() - np.asarray(fj)).max() <= 1e-5
    kp = np.array([[5.0, 7.0], [31.2, 17.9], [94.5, 95.0], [0.0, 40.0], [60.3, 2.1]], np.float32)
    dj = np.asarray(jax.jit(JA.sddh_descriptors, static_argnames=("K", "M"))(
        pj, fj[0], jnp.asarray(kp), K=3, M=16))
    dt = TA.sddh_descriptors(pt, ft[0], torch.as_tensor(kp), K=3, M=16).numpy()
    assert np.abs(dj - dt).max() <= 1e-5
    gray = images[0][:64, :80][None, ..., None]
    sj, dj = jax.jit(JA.aliked_forward)(cj, jnp.asarray(gray))
    st, dt = TA.aliked_forward(ct, torch.as_tensor(gray))
    assert np.abs(st.numpy() - np.asarray(sj)).max() <= 1e-5
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-5


def test_extract_ckpt_matches_jax(params, images):
    pj, pt, _, _ = params
    for img, k in ((images[0], 256), (images[1], 96)):
        fa = JA.extract_aliked_ckpt(pj, jnp.asarray(img), max_keypoints=k)
        fb = TA.extract_aliked_ckpt(pt, torch.as_tensor(img), max_keypoints=k)
        _feats_close(fa, fb)


def test_extract_compact_matches_jax(params, images):
    _, _, cj, ct = params
    fa = JA.extract_aliked(cj, jnp.asarray(images[0]), max_keypoints=256, score_threshold=0.5)
    fb = TA.extract_aliked(ct, torch.as_tensor(images[0]), max_keypoints=256, score_threshold=0.5)
    _feats_close(fa, fb)


def test_one_npz_serves_both(tmp_path, params, images):
    sys.path.insert(0, "scripts")
    from convert_weights import convert_aliked
    from test_weight_converters import _torch_aliked_sd

    sd = _torch_aliked_sd(np.random.default_rng(0), K=3, M=4)
    torch.save(sd, tmp_path / "mini.pth")
    convert_aliked(str(tmp_path / "mini.pth"), str(tmp_path / "mini.npz"))
    pj = JA.load_aliked(str(tmp_path / "mini.npz"))
    pt = TA.load_aliked(str(tmp_path / "mini.npz"), device="cpu")
    assert TA.is_faithful(pt) and "block1.conv1.weight" in pj
    for k, v in sd.items():  # the converter's HWIO back to the state dict's layout
        np.testing.assert_array_equal(pt[k].numpy(), v.numpy())
    img = images[0][:80, :96]
    fa = JA.extract_aliked_ckpt(pj, jnp.asarray(img), max_keypoints=128, score_threshold=0.0)
    fb = TA.extract_aliked_ckpt(pt, torch.as_tensor(img), max_keypoints=128, score_threshold=0.0)
    _feats_close(fa, fb)
    # the compact tier: an npz written from JAX's params overlays both inits
    _, _, cj, _ = params
    np.savez(tmp_path / "compact.npz", **{k: np.asarray(v) for k, v in cj.items()})
    cj2 = JA.load_aliked(str(tmp_path / "compact.npz"))
    ct2 = TA.load_aliked(str(tmp_path / "compact.npz"), device="cpu")
    assert not TA.is_faithful(ct2)
    fa = JA.extract_aliked(cj2, jnp.asarray(img), max_keypoints=64, score_threshold=0.5)
    fb = TA.extract_aliked(ct2, torch.as_tensor(img), max_keypoints=64, score_threshold=0.5)
    _feats_close(fa, fb)
    fresh = TA.load_aliked(str(tmp_path / "missing.npz"), device="cpu")
    assert {k: tuple(v.shape) for k, v in TA.params_to_numpy(fresh).items()} == {
        k: tuple(v.shape) for k, v in jax.eval_shape(lambda: JA.load_aliked(None)).items()}
