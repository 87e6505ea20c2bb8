"""The port's Features and Matching stages for the detectors and matcher
of this slice (``app/pipeline.py``, ``app/cli.py``) against the JAX
package's stages, on the CPU.

- ``detect_features`` for ORB, AKAZE, SURF (hessian threshold 500) and
  ALIKED (both tiers, from npz files of random compact and ``aliked-t16``
  weights through ``--aliked-checkpoint``) on the same
  2-image 128x96 textured-sphere workdir (JAX's ``extract_metadata``):
  the npz contract (keys, shapes), the same valid keypoints; ``xys``
  exact for ORB and SURF, within 0.05 px for AKAZE (a subpixel fit the
  blur's rounding moves) and 1e-4 for ALIKED; descriptors of the common
  keypoints within 1e-4 (the binary ones equal), bearings within 1e-6.
- ``match_features(matching_type="lightglue")`` through the CLI's
  ``--lightglue-checkpoint``, on JAX's SIFT features of 3 views (the
  second a copy of the first): the trainable tier from an npz of JAX's
  ``init_lightglue`` params and the faithful tier from an official-schema
  npz (128 wide, 2 layers, 4 heads). Random weights match nothing (the
  layers collapse the features), so both npz are made near the identity:
  the input and final projections the identity, each residual update
  scaled by 0.005 (still computed), the matchability high. The putative
  matches of every pair equal JAX's (the copied pair matched), and with
  JAX's RANSAC draws fed to the verification the ``matches.json`` equal
  JAX's.
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from splat_one_tpu.app import pipeline as jpipeline
from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu.models import lightglue_tpu as JLG
from splat_one_tpu.sfm import matching as JM
from splat_one_tpu_torch.app import cli, pipeline
from splat_one_tpu_torch.models import aliked_tpu as TAl
from splat_one_tpu_torch.models import lightglue_tpu as TLG
from splat_one_tpu_torch.sfm import matching as TM
from test_app_pipeline import textured_sphere_images
from test_torch_sfm_matching import _jax_verify_draws


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the SfM test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 128, 96


def _workdir(path, n_views, dup_first=False):
    os.makedirs(os.path.join(path, "images"))
    c2ws, Ks = ring_cameras(8, 2.0, -0.3, 60.0, W, H)
    ims = textured_sphere_images(c2ws[:n_views], Ks[:n_views], W, H)
    if dup_first:
        ims = [ims[0]] + list(ims)
    for i, im in enumerate(ims):
        Image.fromarray((im * 255).astype(np.uint8)).convert("RGB").save(
            os.path.join(path, "images", f"v{i}.png"))
    jpipeline.extract_metadata(path)
    return path


@pytest.fixture(scope="module")
def aliked_npz(tmp_path_factory):
    """npz files that both packages load: the faithful tier's (aliked-t16)
    and the compact tier's (without a file their initializations differ
    in bits). ``test_torch_models_aliked.py`` writes them from JAX's params."""
    d = tmp_path_factory.mktemp("w")
    out = {}
    for name, p in (("ALIKED-ckpt", TAl.init_aliked_ckpt("aliked-t16", device="cpu")),
                    ("ALIKED", TAl.init_aliked(device="cpu"))):
        out[name] = str(d / f"{name}.npz")
        np.savez(out[name], **TAl.params_to_numpy(p))
    return out


def _npz(wd, name):
    with np.load(os.path.join(wd, "features", name + ".features.npz")) as z:
        return {k: z[k] for k in z.files}


CASES = {
    "ORB": (dict(feature_type="ORB"), 0.0),
    "AKAZE": (dict(feature_type="AKAZE"), 0.05),
    "SURF": (dict(feature_type="SURF", surf_hessian_threshold=500.0), 0.0),
    "ALIKED": (dict(feature_type="ALIKED"), 1e-4),
    "ALIKED-ckpt": (dict(feature_type="ALIKED"), 1e-4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_detect_features_matches_jax(tmp_path, aliked_npz, case):
    kw, xy_tol = CASES[case]
    kw = dict(kw, max_keypoints=256, feature_process_size=W)
    if case.startswith("ALIKED"):
        kw["aliked_checkpoint"] = aliked_npz[case]
    wd_j = _workdir(str(tmp_path / "j"), 2)
    wd_t = str(tmp_path / "t")
    shutil.copytree(wd_j, wd_t)
    assert jpipeline.detect_features(wd_j, **kw) == 2
    if case == "SURF":  # the CLI has no surf_* flags (as in JAX)
        assert pipeline.detect_features(wd_t, device="cpu", **kw) == 2
    else:
        argv = ["detect-features", wd_t, "--feature-type", kw["feature_type"],
                "--max-keypoints", "256", "--feature-process-size", str(W), "--device", "cpu"]
        if case.startswith("ALIKED"):
            argv += ["--aliked-checkpoint", aliked_npz[case]]
        assert cli.main(argv) == 0
    for name in ("v0.png", "v1.png"):
        a, b = _npz(wd_j, name), _npz(wd_t, name)
        assert set(b) == set(a) and all(b[k].shape == a[k].shape for k in a)
        assert b["descriptors"].shape[0] == 256
        np.testing.assert_array_equal(b["valid"], a["valid"])
        v = a["valid"]
        assert v.sum() >= 15, (case, v.sum())
        assert np.abs(b["xys"][v] - a["xys"][v]).max() <= xy_tol
        assert np.abs(b["descriptors"][v] - a["descriptors"][v]).max() <= 1e-4
        assert np.abs(b["bearings"][v] - a["bearings"][v]).max() <= 1e-6 + xy_tol / W
        assert b["angular_res"] == a["angular_res"] and b["width"] == W


@pytest.fixture(scope="module")
def sift_workdir(tmp_path_factory):
    """JAX's SIFT features of 3 views, the second a copy of the first."""
    wd = _workdir(str(tmp_path_factory.mktemp("lg") / "wd"), 2, dup_first=True)
    jpipeline.detect_features(wd, max_keypoints=256, feature_process_size=W)
    return wd


def _near_identity(p, faithful):
    """Weights (numpy) whose layers pass each descriptor almost unchanged."""
    p = {k: np.array(v) for k, v in p.items()}
    eye = np.eye(128, dtype=np.float32)
    if faithful:
        p["input_proj.weight"], p["input_proj.bias"] = eye, 0 * p["input_proj.bias"]
        for k in p:
            if k.endswith("ffn.3.weight") or k.endswith("ffn.3.bias"):
                p[k] *= 0.005
            if ".final_proj." in k:
                p[k] = 30 * eye if k.endswith("weight") else 0 * p[k]
            if ".matchability." in k:
                p[k] = 0 * p[k] + (8.0 if k.endswith("bias") else 0.0)
    else:
        p["in_proj_w"], p["final_w"] = eye, eye
        for k in p:
            if "_ffn2_" in k:
                p[k] *= 0.005
        p["matchability_w"] *= 0
        p["matchability_b"] += 8.0
    return p


@pytest.mark.parametrize("tier", ["trainable", "faithful"])
def test_match_features_lightglue(tmp_path, sift_workdir, monkeypatch, tier):
    ckpt = str(tmp_path / "lg.npz")
    if tier == "trainable":
        p = jax.jit(JLG.init_lightglue, static_argnums=1)(jax.random.PRNGKey(0), 128)
    else:
        p = TLG.params_to_numpy(TLG.init_lightglue_ckpt(
            input_dim=128, descriptor_dim=128, n_layers=2, n_heads=4, device="cpu"))
    np.savez(ckpt, **_near_identity(p, tier == "faithful"))
    wd_j, wd_t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(sift_workdir, wd_j)
    shutil.copytree(sift_workdir, wd_t)
    assert TLG.is_faithful(TLG.load_lightglue(ckpt, device="cpu")) == (tier == "faithful")
    # each stage's putative matches, as it hands them to the verification
    raw = {}

    def spy(name, module, fn):
        def wrapped(*a, **kw):
            raw[name] = dict(a[1] if name == "jax" else a[0])
            return fn(*a, **kw)
        monkeypatch.setattr(module, "robust_filter_matches_batched", wrapped)

    spy("jax", JM, JM.robust_filter_matches_batched)
    spy("port", TM, TM.robust_filter_matches_batched)
    # the verification takes JAX's draws: the stages then agree exactly
    draws = _jax_verify_draws(jax.random.PRNGKey(0), 3)
    monkeypatch.setattr(TM, "verify_draws", lambda n, seed=0, device="cuda": torch.as_tensor(
        draws[:n], device=device))
    jpipeline.match_features(wd_j, matching_type="lightglue", lightglue_checkpoint=ckpt)
    assert cli.main(["match-features", wd_t, "--matching-type", "lightglue",
                     "--lightglue-checkpoint", ckpt, "--device", "cpu"]) == 0
    assert set(raw["port"]) == set(raw["jax"]) == {(0, 1), (0, 2), (1, 2)}
    for p_ in raw["jax"]:
        np.testing.assert_array_equal(raw["port"][p_], raw["jax"][p_])
    assert len(raw["jax"][(0, 1)]) >= 20, len(raw["jax"][(0, 1)])
    mj = json.load(open(os.path.join(wd_j, "matches", "matches.json")))
    mt = json.load(open(os.path.join(wd_t, "matches", "matches.json")))
    assert mt == mj and len(mj.get("v0.png|v1.png", [])) >= 20
