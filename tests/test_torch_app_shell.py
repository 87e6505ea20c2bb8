"""The port's app shell against the JAX package's, on the CPU:
``app/image_processing.py`` (``resize_images`` / ``restore_originals``),
``app/pipeline.py`` (``visualize_features`` / ``visualize_matches``),
``app/recon_viewer.py``, ``app/mask_ui.py`` and the package's top level.

- Resize and restore over the same workdir (a 96x64 JPEG with EXIF, a
  80x120 PNG and one already small): every file under ``images/`` and
  ``images_org/`` byte-equal to JAX's after the resize, and after the
  restore (the originals back, bit for bit).
- The keypoint and match previews from the same features and
  ``matches.json`` (features written at half the image size, so the
  previews scale them; matches stored b|a for one pair): the PNGs
  byte-equal to JAX's.
- ``LiveReconViewer``: the same seeded poses and points (more points than
  ``max_points``, so both subsample) through ``update``; ``/state`` from
  both servers within 1e-6 abs of each other (rotations from each
  package's ``_rodrigues`` in f32); ``/`` serves the page.
- ``MaskUIServer`` with the classical predictor (no checkpoint), on an
  ephemeral port: ``/images``, the page, ``/predict``'s overlay PNG and
  ``/save``'s ``masks/<img>.png`` and ``masks_clicks.json`` byte-equal to
  JAX's server's; then the port's ``create_masks`` replays the clicks
  into the same PNG bytes.
- ``splat_one_tpu_torch.rasterization`` / ``.Trainer`` / ``.Config`` are
  the port's, loaded lazily; any other name raises AttributeError.
"""

import json
import os
import shutil
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from splat_one_tpu.app import image_processing as jip
from splat_one_tpu.app import mask_ui as jmask
from splat_one_tpu.app import pipeline as jpipeline
from splat_one_tpu.app import recon_viewer as jrv
from splat_one_tpu_torch.app import image_processing as tip
from splat_one_tpu_torch.app import mask_ui as tmask
from splat_one_tpu_torch.app import pipeline as tpipeline
from splat_one_tpu_torch.app import recon_viewer as trv

STATE_ATOL = 1e-6


def _noise_image(rng, h, w):
    img = rng.uniform(0, 255, (h, w, 3))
    img[h // 4: h // 2, w // 4: w // 2] = [220, 40, 40]
    return img.astype(np.uint8)


def _files(d):
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


@pytest.fixture
def shell_workdirs(tmp_path):
    """Two identical workdirs (JAX's, the port's)."""
    rng = np.random.default_rng(0)
    wd = tmp_path / "j"
    (wd / "images").mkdir(parents=True)
    exif = Image.Exif()
    exif[0x010F] = "Acme"  # Make
    exif[0x0110] = "Cam 1"  # Model
    Image.fromarray(_noise_image(rng, 64, 96)).save(wd / "images" / "a.jpg", exif=exif)
    Image.fromarray(_noise_image(rng, 120, 80)).save(wd / "images" / "b.png")
    Image.fromarray(_noise_image(rng, 20, 24)).save(wd / "images" / "c.png")
    shutil.copytree(wd, tmp_path / "t")
    return str(wd), str(tmp_path / "t")


def test_resize_and_restore_byte_equal(shell_workdirs):
    wd_j, wd_t = shell_workdirs
    originals = _files(os.path.join(wd_t, "images"))
    assert jip.ImageProcessor(wd_j).resize_images(48) == 2
    assert tip.ImageProcessor(wd_t).resize_images(48) == 2
    for sub in ("images", "images_org"):
        assert _files(os.path.join(wd_t, sub)) == _files(os.path.join(wd_j, sub)), sub
    assert _files(os.path.join(wd_t, "images_org")) == originals
    assert Image.open(os.path.join(wd_t, "images", "a.jpg")).size == (48, 32)
    assert Image.open(os.path.join(wd_t, "images", "a.jpg")).getexif()[0x010F] == "Acme"
    assert jip.ImageProcessor(wd_j).restore_originals() == 3
    assert tip.ImageProcessor(wd_t).restore_originals() == 3
    assert _files(os.path.join(wd_t, "images")) == originals
    assert not os.path.exists(os.path.join(wd_t, "images_org"))
    assert tip.ImageProcessor(wd_t).restore_originals() == 0


def test_previews_byte_equal(shell_workdirs):
    wd_j, wd_t = shell_workdirs
    rng = np.random.default_rng(1)
    for wd in shell_workdirs:
        os.makedirs(os.path.join(wd, "features"))
        os.makedirs(os.path.join(wd, "matches"))
    sizes = {"a.jpg": (96, 64), "b.png": (80, 120)}
    feats = {}
    for name, (w, h) in sizes.items():
        n = 40
        xys = (rng.uniform(0, 1, (n, 2)) * [w / 2, h / 2]).astype(np.float32)
        valid = rng.uniform(size=n) > 0.2
        feats[name] = dict(xys=xys, valid=valid, width=np.int64(w // 2),
                           height=np.int64(h // 2))
    matches = {"b.png|a.jpg": rng.integers(0, 40, (25, 2)).tolist()}
    for wd in shell_workdirs:
        for name, z in feats.items():
            np.savez(os.path.join(wd, "features", name + ".features.npz"), **z)
        with open(os.path.join(wd, "matches", "matches.json"), "w") as f:
            json.dump(matches, f)
    assert jpipeline.visualize_features(wd_j) == tpipeline.visualize_features(wd_t) == 2
    d = os.path.join("previews", "features")
    assert _files(os.path.join(wd_t, d)) == _files(os.path.join(wd_j, d))
    pj = jpipeline.visualize_matches(wd_j, "a.jpg", "b.png")
    pt = tpipeline.visualize_matches(wd_t, "a.jpg", "b.png")
    assert os.path.relpath(pt, wd_t) == os.path.relpath(pj, wd_j)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    with pytest.raises(KeyError):
        tpipeline.visualize_matches(wd_t, "a.jpg", "c.png")


def _get(url):
    return urllib.request.urlopen(url, timeout=30).read()


def test_live_viewer_state_matches_jax():
    rng = np.random.default_rng(2)
    poses = {i: np.concatenate([rng.normal(0, 0.5, 3), rng.normal(0, 2, 3)]).astype(
        np.float32) for i in (0, 3, 5)}
    points = {t: rng.normal(0, 3, 3).astype(np.float32) for t in range(300)}
    states = {}
    for name, mod in (("jax", jrv), ("port", trv)):
        v = mod.LiveReconViewer(port=0, max_points=100)
        v.serve_background()
        try:
            base = f"http://127.0.0.1:{v._httpd.server_address[1]}"
            assert json.loads(_get(base + "/state")) == {"points": [], "cams": [],
                                                         "center": [0, 0, 0]}
            v.update(poses, points)
            states[name] = json.loads(_get(base + "/state"))
            assert b"/state" in _get(base + "/")
        finally:
            v.close()
    sj, st = states["jax"], states["port"]
    assert len(st["points"]) == 100 and len(st["cams"]) == 3
    for key in ("points", "cams", "center"):
        a, b = np.asarray(sj[key]), np.asarray(st[key])
        assert a.shape == b.shape, key
        assert np.abs(a - b).max() <= STATE_ATOL, key


def _post(url, spec):
    req = urllib.request.Request(url, data=json.dumps(spec).encode())
    return urllib.request.urlopen(req, timeout=60).read()


@pytest.fixture
def mask_workdirs(tmp_path):
    img = np.random.default_rng(0).uniform(0, 60, (48, 64, 3)).astype(np.uint8)
    img[10:30, 20:40] = [220, 40, 40]  # the object to segment
    out = []
    for name in ("j", "t"):
        d = tmp_path / name / "images"
        d.mkdir(parents=True)
        Image.fromarray(img).save(d / "a.jpg")
        out.append(str(tmp_path / name))
    return out


def test_mask_ui_matches_jax_and_replays(mask_workdirs):
    spec = {"name": "a.jpg", "points": [[30.0, 20.0], [5.0, 5.0]], "labels": [1, 0]}
    got = {}
    for wd, srv in zip(mask_workdirs, (jmask.MaskUIServer(mask_workdirs[0], port=0),
                                       tmask.MaskUIServer(mask_workdirs[1], port=0,
                                                          device="cpu"))):
        srv.serve_background()
        try:
            base = f"http://127.0.0.1:{srv.httpd.server_address[1]}"
            assert json.loads(_get(base + "/images")) == ["a.jpg"]
            page = _get(base + "/").decode()
            png = _post(base + "/predict", spec)
            assert json.loads(_post(base + "/save", spec)) == {}
        finally:
            srv.httpd.shutdown()
            srv.httpd.server_close()
        got[wd] = (page, png, open(os.path.join(wd, "masks", "a.jpg.png"), "rb").read(),
                   open(os.path.join(wd, "masks_clicks.json"), "rb").read())
    (page_j, png_j, mask_j, clicks_j), (page_t, png_t, mask_t, clicks_t) = (
        got[wd] for wd in mask_workdirs)
    assert "shift+click" in page_t and png_t[:4] == b"\x89PNG"
    assert (png_t, mask_t, clicks_t) == (png_j, mask_j, clicks_j)
    m = np.asarray(Image.open(os.path.join(mask_workdirs[1], "masks", "a.jpg.png")))
    assert m[20, 30] == 0 and m[5, 5] == 255  # the clicked object ignored
    os.remove(os.path.join(mask_workdirs[1], "masks", "a.jpg.png"))
    assert tpipeline.create_masks(mask_workdirs[1], device="cpu") == 1
    assert open(os.path.join(mask_workdirs[1], "masks", "a.jpg.png"), "rb").read() == mask_j


def test_mask_ui_defaults_to_cuda(mask_workdirs):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmask.MaskUIServer(mask_workdirs[1], port=0)


def test_package_conveniences():
    import splat_one_tpu_torch as pkg
    from splat_one_tpu_torch.render.rasterization import rasterization
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.trainer import Trainer

    assert pkg.rasterization is rasterization
    assert pkg.Trainer is Trainer and pkg.Config is Config
    with pytest.raises(AttributeError, match="no_such_name"):
        pkg.no_such_name
