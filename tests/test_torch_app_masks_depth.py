"""Port parity: the Masks and Depth stages (``app/pipeline.create_masks``,
``estimate_depth`` and their CLI subcommands) against the JAX package, on
a 2-view 96x96 textured-sphere workdir on the CPU.

- ``cli create-masks --device cpu`` with a clicks file writes JAX's
  ``masks/<img>.png`` bytes: the classical region grower (numpy in both)
  and the faithful SAM 2.1 on a mini ``.npz`` from ``convert_sam2``
  (``tests/test_sam2_parity.py``'s ``MINI`` trunk in place of
  ``hiera_l`` and a 64 px input, patched into both packages): the masks
  equal, since no logit of these inputs lies within 1e-4 of 0.
- ``cli estimate-depth --device cpu`` on a mini DA-V2 ``.npz`` from
  ``convert_depth`` (its schema patched in as ``vits``, the CLI's
  default encoder, in both packages): the default path, ``--equirect`` and
  ``--camera-aware`` with a fisheye camera write JAX's ``.npy`` within
  1e-4 of its largest entry, and a PNG beside each.
"""

import functools
import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch
from PIL import Image

sys.path.insert(0, "scripts")

from convert_weights import convert_depth, convert_sam2  # noqa: E402
from splat_one_tpu.app import pipeline as jpipeline  # noqa: E402
from splat_one_tpu.models import depth_tpu as JD  # noqa: E402
from splat_one_tpu.models import sam2_hiera as JS  # noqa: E402
from splat_one_tpu_torch.app import cli, pipeline  # noqa: E402
from splat_one_tpu_torch.models import depth_tpu as TD  # noqa: E402
from splat_one_tpu_torch.models import sam2_hiera as TS  # noqa: E402
from test_sam2_parity import MINI, _sd_mini  # noqa: E402
from test_torch_app_sfm import _write_ring  # noqa: E402
from test_weight_converters import _torch_dav2_sd  # noqa: E402

CLICKS = {"view_00.png": {"points": [[48, 48], [3, 3]], "labels": [1, 0]},
          "view_01.png": {"points": [[40, 52]], "labels": [1]}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """The 2-view workdir after extract-metadata, with a clicks file."""
    wd = str(tmp_path_factory.mktemp("md") / "base")
    _write_ring(wd, n=2, res=96)
    pipeline.extract_metadata(wd)
    with open(os.path.join(wd, "masks_clicks.json"), "w") as f:
        json.dump(CLICKS, f)
    return wd


def _pair(base, tmp_path):
    wd_j, wd_t = str(tmp_path / "j"), str(tmp_path / "t")
    shutil.copytree(base, wd_j)
    shutil.copytree(base, wd_t)
    return wd_j, wd_t


def _mask_bytes(wd):
    d = os.path.join(wd, "masks")
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_create_masks_classical(base, tmp_path):
    wd_j, wd_t = _pair(base, tmp_path)
    assert jpipeline.create_masks(wd_j) == 2
    assert cli.main(["create-masks", wd_t, "--device", "cpu"]) == 0
    got = _mask_bytes(wd_t)
    assert list(got) == ["view_00.png.png", "view_01.png.png"]
    assert got == _mask_bytes(wd_j)
    m = np.asarray(Image.open(os.path.join(wd_t, "masks", "view_00.png.png")))
    assert m.shape == (96, 96) and m[48, 48] == 0 and m[3, 3] == 255  # inverted
    # no clicks file: nothing to do
    assert pipeline.create_masks(wd_t, clicks_path=str(tmp_path / "none.json"),
                                 device="cpu") == 0


def test_create_masks_faithful_mini(base, tmp_path, monkeypatch):
    torch.save(_sd_mini(np.random.default_rng(0)), tmp_path / "mini.pt")
    npz = str(tmp_path / "sam2_mini.npz")
    convert_sam2(str(tmp_path / "mini.pt"), npz)
    for m in (JS, TS):
        monkeypatch.setitem(m.CONFIGS, "hiera_l", MINI)
        monkeypatch.setattr(m, "SAM2Predictor", functools.partial(m.SAM2Predictor, img_size=64))
    wd_j, wd_t = _pair(base, tmp_path)
    assert jpipeline.create_masks(wd_j, checkpoint=npz) == 2
    assert cli.main(["create-masks", wd_t, "--checkpoint", npz, "--device", "cpu"]) == 0
    assert _mask_bytes(wd_t) == _mask_bytes(wd_j)


@pytest.fixture(scope="module")
def depth_ckpt(tmp_path_factory):
    d = tmp_path_factory.mktemp("dav2")
    torch.save(_torch_dav2_sd(np.random.default_rng(0), C=32, D=4, heads=2, F=16),
               d / "mini.pth")
    convert_depth(str(d / "mini.pth"), "mini", str(d / "mini.npz"))
    return str(d / "mini.npz")


def _fisheye(wd):
    with open(os.path.join(wd, "camera_models.json")) as f:
        models = json.load(f)
    for m in models.values():
        m.update(projection_type="fisheye", focal=0.4, k1=0.02, k2=-0.01, c_x=0.01)
    with open(os.path.join(wd, "camera_models.json"), "w") as f:
        json.dump(models, f)


@pytest.mark.parametrize("mode", ["default", "equirect", "camera-aware"])
def test_estimate_depth(base, tmp_path, monkeypatch, depth_ckpt, mode):
    # the mini schema under the CLI's default encoder name, in both packages
    for cfgs in (JD.CONFIGS, TD.CONFIGS):
        monkeypatch.setitem(cfgs, "vits", dict(width=32, depth=4, heads=2, features=16))
    wd_j, wd_t = _pair(base, tmp_path)
    if mode == "camera-aware":
        _fisheye(wd_j)
        _fisheye(wd_t)
    flags = {"default": [], "equirect": ["--equirect"], "camera-aware": ["--camera-aware"]}[mode]
    assert jpipeline.estimate_depth(wd_j, checkpoint=depth_ckpt, equirect=mode == "equirect",
                                    camera_aware=mode == "camera-aware") == 2
    assert cli.main(["estimate-depth", wd_t, "--checkpoint", depth_ckpt, "--device", "cpu"]
                    + flags) == 0
    for name in ("view_00", "view_01"):
        want = np.load(os.path.join(wd_j, "depth", f"{name}_depth.npy"))
        got = np.load(os.path.join(wd_t, "depth", f"{name}_depth.npy"))
        assert got.shape == want.shape == (96, 96) and got.dtype == np.float32
        assert np.abs(want).max() > 0
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), (mode, name)
        assert os.path.exists(os.path.join(wd_t, "depth", f"{name}_depth.png"))
    if mode == "camera-aware":
        assert (got == 0).any()  # outside the fisheye's FOV
