"""A workdir the JAX package began, continued by the port, on the CPU:
the JAX package's ``extract_metadata`` and ``detect_features`` write
``exif/``, ``camera_models.json`` and ``features/*.features.npz`` for the
12-view 256x256 textured-sphere ring; the port's ``match_features``,
``create_tracks`` and ``reconstruct`` read them and register every view
within JAX ``test_full_pipeline``'s bars (median < 0.08, max < 0.15 of
the spread). The port's ``matches.json`` also feeds the JAX package's
``create_tracks`` to the same ``tracks.json`` bytes.
"""

import os

import numpy as np
import pytest
import torch

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
