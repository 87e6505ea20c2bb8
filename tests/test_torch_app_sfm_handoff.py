"""Workdirs the JAX package began, continued by the port, on the CPU:
the JAX package's ``extract_metadata`` and ``detect_features`` write
``exif/``, ``camera_models.json`` and ``features/*.features.npz`` for the
12-view 256x256 textured-sphere ring; the port's ``match_features``,
``create_tracks`` and ``reconstruct`` read them and register every view
within JAX ``test_full_pipeline``'s bars (median < 0.08, max < 0.15 of
the spread). The port's ``matches.json`` also feeds the JAX package's
``create_tracks`` to the same ``tracks.json`` bytes. Masks the port's
``create_masks`` writes are honoured by either package's
``detect_features`` as JAX's own masks are: the same features.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from splat_one_tpu.app import camera_models as jcm
from splat_one_tpu.app import pipeline as jpipeline
from splat_one_tpu_torch.app import pipeline
from splat_one_tpu_torch.data.opensfm import Parser
from test_torch_app_sfm import N_VIEWS, RES, _aligned_errors, _set_true_focal, _write_ring


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_continues_jax_workdir(tmp_path):
    wd = str(tmp_path / "ring")
    c2ws, Ks = _write_ring(wd)
    jpipeline.extract_metadata(wd)
    _set_true_focal(wd, Ks, RES, jcm.CameraModelManager)
    jpipeline.detect_features(wd, max_keypoints=2048, feature_process_size=1024)
    assert pipeline.match_features(wd, device="cpu") > 20
    assert pipeline.create_tracks(wd) > 500
    tracks = open(os.path.join(wd, "tracks.json"), "rb").read()
    jpipeline.create_tracks(wd)
    assert open(os.path.join(wd, "tracks.json"), "rb").read() == tracks
    report = pipeline.reconstruct(wd, device="cpu")
    assert report["n_images"] == N_VIEWS, report
    err = _aligned_errors(wd, c2ws, Parser)
    assert np.median(err) < 0.08 and err.max() < 0.15, err


def test_port_continues_jax_akaze_workdir(tmp_path):
    """The JAX package's AKAZE features (MSURF, 64-D) on the same ring, the
    port's matching, tracks and reconstruction: the 64-D descriptors and
    their bearings read as they are, JAX's ``create_tracks`` reproduces the
    port's ``tracks.json`` from its ``matches.json``, and at least 7 views
    register (the JAX package's own stages register 7 of the 12 on these
    features: measured, not a bar it holds), their centres within the bars
    above after aligning the registered ones."""
    wd = str(tmp_path / "ring")
    c2ws, Ks = _write_ring(wd)
    jpipeline.extract_metadata(wd)
    _set_true_focal(wd, Ks, RES, jcm.CameraModelManager)
    jpipeline.detect_features(wd, max_keypoints=2048, feature_process_size=1024,
                              feature_type="AKAZE")
    with np.load(os.path.join(wd, "features", "view_00.png.features.npz")) as z:
        assert z["descriptors"].shape == (2048, 64) and z["valid"].sum() > 200
    assert pipeline.match_features(wd, device="cpu") > 15
    assert pipeline.create_tracks(wd) > 300
    tracks = open(os.path.join(wd, "tracks.json"), "rb").read()
    jpipeline.create_tracks(wd)
    assert open(os.path.join(wd, "tracks.json"), "rb").read() == tracks
    report = pipeline.reconstruct(wd, device="cpu")
    assert report["n_images"] >= 7, report
    p = Parser(wd, normalize=False)
    idx = [int(nm[5:7]) for nm in p.image_names]
    err = _aligned_errors(wd, c2ws[idx], Parser, names=p.image_names)
    assert np.median(err) < 0.08 and err.max() < 0.15, err


def test_port_masks_honoured_as_jax_masks(tmp_path):
    """The port's ``create_masks`` (classical) on a 2-view ring, and the
    JAX package's on a copy: the same mask bytes, and each package's
    ``detect_features`` gives the same features on either workdir, with
    no valid keypoint inside a masked-out region."""
    base = str(tmp_path / "base")
    _write_ring(base, n=2, res=96)
    pipeline.extract_metadata(base)
    with open(os.path.join(base, "masks_clicks.json"), "w") as f:
        json.dump({"view_00.png": {"points": [[48, 48], [2, 2]], "labels": [1, 0]},
                   "view_01.png": {"points": [[48, 48], [90, 5]], "labels": [1, 0]}}, f)
    wd_j, wd_t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(base, wd_j)
    shutil.copytree(base, wd_t)
    assert jpipeline.create_masks(wd_j) == 2
    assert pipeline.create_masks(wd_t, device="cpu") == 2
    kw = dict(max_keypoints=256, feature_process_size=96)
    jpipeline.detect_features(wd_j, **kw)
    jpipeline.detect_features(wd_t, **kw)
    for name in ("view_00.png", "view_01.png"):
        rel = os.path.join("masks", name + ".png")
        assert open(os.path.join(wd_t, rel), "rb").read() == open(os.path.join(wd_j, rel),
                                                                  "rb").read()
        fj, ft = (np.load(os.path.join(w, "features", name + ".features.npz"))
                  for w in (wd_j, wd_t))
        np.testing.assert_array_equal(ft["valid"], fj["valid"])
        np.testing.assert_array_equal(ft["xys"], fj["xys"])
    # the port's detect_features drops the masked keypoints too: the
    # unmasked run's keypoints that fall inside the masked-out region
    pipeline.detect_features(base, device="cpu", **kw)
    pipeline.detect_features(wd_t, device="cpu", **kw)
    for name in ("view_00.png", "view_01.png"):
        m = np.asarray(Image.open(os.path.join(wd_t, "masks", name + ".png")))
        kept = []
        for w in (base, wd_t):
            with np.load(os.path.join(w, "features", name + ".features.npz")) as z:
                kept.append(z["xys"][z["valid"]].astype(int))
        inside = m[kept[0][:, 1], kept[0][:, 0]] > 127
        assert (~inside).sum() > 5  # the mask had keypoints to drop
        np.testing.assert_array_equal(kept[1], kept[0][inside])
