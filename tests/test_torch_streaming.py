"""Port parity: ``data/streaming.StreamingImages`` and
``utils/native_loader`` against the JAX package on the same images
(mirroring tests/test_streaming.py and tests/test_native_loader.py).

- The port's native library builds into ``splat_one_tpu_torch/_build/``
  and never writes into ``native/``.
- Native decodes equal the JAX binding's bit for bit (the same
  ``native/loader.cpp``); the PIL path equals the JAX PIL path bit for bit
  and decodes PNG exactly.
- ``backend`` says which decoder ran.
- A Trainer trains on a streaming scene, prefetching each next batch, and
  its losses equal those of the same scene in RAM (rtol 1e-6).
"""

import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from splat_one_tpu.data.streaming import StreamingImages as JStreamingImages
from splat_one_tpu.utils import native_loader as jnative
from splat_one_tpu_torch.data import streaming
from splat_one_tpu_torch.data.streaming import StreamingImages
from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg
from splat_one_tpu_torch.train.trainer import Trainer
from splat_one_tpu_torch.utils import native_loader

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "native")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def imgdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    img = (rng.uniform(size=(96, 128, 3)) * 255).astype(np.uint8)
    Image.fromarray(img).save(d / "a.png")
    Image.fromarray(img).save(d / "a.jpg", quality=95)
    return d, img


def _snapshot(d):
    """mtimes of ``native/``'s files, but for the JAX binding's own build
    (``libsplatloader.so``, which its tests may write at any time)."""
    return {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in sorted(os.listdir(d))
            if f != "libsplatloader.so"}


def test_native_library_builds_outside_native(imgdir):
    before = _snapshot(NATIVE_DIR)
    if not native_loader.available():
        assert native_loader.build_error(), "an unavailable loader says why"
        pytest.skip(f"no native toolchain here: {native_loader.build_error()}")
    lib = native_loader._target()
    assert lib.exists() and lib.parent == native_loader.BUILD_DIR
    assert _snapshot(NATIVE_DIR) == before
    assert not [f for f in os.listdir(NATIVE_DIR) if f.startswith("libsplatloader-")]
    assert not [f for f in os.listdir(native_loader.BUILD_DIR) if f.endswith(".tmp")]
    d, _ = imgdir
    ldr = native_loader.NativeImageLoader(2)
    ldr.wait(ldr.submit(str(d / "a.png"), 128, 96))
    ldr.close()
    assert _snapshot(NATIVE_DIR) == before


def test_native_loader_matches_jax(imgdir):
    if not jnative.available():
        pytest.skip("no native toolchain for the JAX binding")
    d, img = imgdir
    assert native_loader.available(), native_loader.build_error()
    ldr, jldr = native_loader.NativeImageLoader(2), jnative.NativeImageLoader(2)
    K = np.array([[100.0, 0, 64], [0, 100.0, 48], [0, 0, 1]])
    for name in ("a.png", "a.jpg"):
        for w, h, kw in ((128, 96, {}), (64, 48, {}),
                         (128, 96, dict(K=K, dist=np.array([0.1, 0.0])))):
            out = ldr.wait(ldr.submit(str(d / name), w, h, **kw))
            np.testing.assert_array_equal(out, jldr.wait(jldr.submit(str(d / name), w, h, **kw)))
            assert out.shape == (h, w, 3) and out.dtype == np.float32
    ref = img.astype(np.float32) / 255.0
    out = ldr.wait(ldr.submit(str(d / "a.png"), 128, 96))
    np.testing.assert_allclose(out[1:-1, 1:-1], ref[1:-1, 1:-1], atol=1e-6)
    batch = ldr.load_batch([str(d / "a.png")] * 4, 64, 48)
    assert batch.shape == (4, 48, 64, 3)
    np.testing.assert_array_equal(batch[0], batch[3])
    with pytest.raises(IOError):
        ldr.wait(ldr.submit("/nonexistent/img.png", 8, 8))
    ldr.close()
    jldr.close()


def _write_images(d, images):
    paths = []
    for i, img in enumerate(images):
        p = d / f"im_{i:03d}.png"
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(p)
        paths.append(str(p))
    return paths


@pytest.mark.parametrize("backend", ["native", "pil"])
def test_streaming_images_match_jax(backend, tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(10, 24, 32, 3)).astype(np.float32)
    paths = _write_images(tmp_path, imgs)
    if backend == "pil":
        monkeypatch.setattr(streaming.native_loader, "available", lambda: False)
        monkeypatch.setattr("splat_one_tpu.utils.native_loader.available", lambda: False)
    elif not native_loader.available():
        pytest.skip(f"no native toolchain here: {native_loader.build_error()}")
    st = StreamingImages(paths, 32, 24, cache_images=4)
    jst = JStreamingImages(paths, 32, 24, cache_images=4)
    assert st.backend == backend and (jst._native is None) == (backend == "pil")
    assert st.shape == jst.shape == (10, 24, 32, 3) and st.dtype == np.float32
    idx = np.array([1, 5, 7])
    np.testing.assert_array_equal(st[idx], jst[idx])
    np.testing.assert_array_equal(st[3], jst[3])
    if backend == "pil":  # PNG decodes exactly
        u8 = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(st[idx], u8[idx].astype(np.float32) / 255.0)
    st.prefetch(np.arange(10))
    _ = [st[i] for i in range(10)]
    assert st.cached_count <= 4  # the LRU bound holds
    # undistortion on load: Brown k1/k2 (native or host) and fisheye (host)
    Ks = np.tile(np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32), (10, 1, 1))
    dists = np.tile(np.array([0.05, 0.0, 0.0, 0.0], np.float32), (10, 1))
    types = ["fisheye" if i % 2 else "perspective" for i in range(10)]
    st = StreamingImages(paths, 32, 24, Ks=Ks, dists=dists, camera_types=types)
    jst = JStreamingImages(paths, 32, 24, Ks=Ks, dists=dists, camera_types=types)
    np.testing.assert_array_equal(st[np.arange(4)], jst[np.arange(4)])


def test_trainer_on_streaming_scene(tmp_path, monkeypatch):
    """A streaming scene trains (the Trainer's in-RAM image budget check
    is skipped for it), each next batch is prefetched, and the losses are
    those of the same images in RAM."""
    scene, _ = make_synthetic_scene(n_gaussians=300, n_cameras=6, width=48, height=48,
                                    n_points=150, device="cpu")
    paths = _write_images(tmp_path, scene.images)
    u8 = np.stack([np.asarray(Image.open(p)) for p in paths])
    monkeypatch.setattr(streaming.native_loader, "available", lambda: False)
    st = StreamingImages(paths, 48, 48, cache_images=3)
    assert st.backend == "pil"
    calls = []  # the Trainer's own prefetches (indexing prefetches too)
    prefetch = st.prefetch

    def counted(idx):
        if sys._getframe(1).f_code.co_name == "train":
            calls.append(np.array(idx))
        prefetch(idx)

    monkeypatch.setattr(st, "prefetch", counted)
    cfg = lambda d: Config(
        max_steps=6, eval_steps=[6], save_steps=[], sh_degree=1, capacity=512, batch_size=2,
        test_every=6, camera_model="pinhole", result_dir=str(tmp_path / d),
        strategy=DefaultStrategyCfg(refine_start_iter=10_000, refine_stop_iter=10_001,
                                    refine_every=10_000, reset_every=10_000))
    tr = Trainer(cfg("s"), scene._replace(images=st), device="cpu")
    hist = tr.train(log_every=1)
    assert len(calls) == 6 and all(len(c) == 2 for c in calls)
    assert st.cached_count <= 3
    ram = Trainer(cfg("r"), scene._replace(images=u8), device="cpu")
    hist_r = ram.train(log_every=1)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in hist_r],
                               rtol=1e-6)
    assert tr.eval(6)["psnr"] > 5
