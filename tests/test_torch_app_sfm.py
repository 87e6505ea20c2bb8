"""The port's SfM stages and CLI (``app/pipeline.py``, ``app/cli.py``,
``app/exif.py``, ``app/image_processing.py``, ``app/camera_models.py``)
against the JAX package, on the CPU.

- ``extract_metadata`` by both packages over the same workdir of images
  (one JPEG with EXIF focal, GPS, make and model written by PIL): the
  ``exif/*.exif`` and ``camera_models.json`` files byte-equal; so are
  ``CameraModelManager``'s overrides and their propagation, and
  ``ImageProcessor.apply_image_descriptions``' geotags.
- ``cli run-all --device cpu`` on a 12-view 256x256 textured-sphere ring
  (the smallest ring that registers every view: 8 or 10 views, or 128 px,
  register two), the true focal set through ``CameraModelManager``: every
  view registered, aligned centres within JAX ``test_full_pipeline``'s
  bars (median < 0.08, max < 0.15 of the spread); the JAX package's
  ``create_tracks`` and ``Parser`` read the port's ``matches.json`` and
  ``reconstruction.json`` (the same ``tracks.json`` bytes).
- The mask stage: keypoints inside ``masks/<img>.png`` are dropped.
- The SfM subcommands run on CUDA by default (they refuse here); the
  options of later slices exit non-zero and name their slice.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch
from PIL import Image

from splat_one_tpu.app import camera_models as jcm
from splat_one_tpu.app import image_processing as jip
from splat_one_tpu.app import pipeline as jpipeline
from splat_one_tpu.data.synthetic import ring_cameras
from splat_one_tpu_torch.app import camera_models, cli, image_processing, pipeline
from test_app_pipeline import textured_sphere_images


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the SfM runs thousands of tiny ops, which
    spin-wait themselves to a crawl when several test workers each run a
    thread per core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N_VIEWS, RES = 12, 256


def _write_ring(wd, n=N_VIEWS, res=RES):
    os.makedirs(os.path.join(wd, "images"))
    c2ws, Ks = ring_cameras(n, 2.0, -0.3, 60.0, res, res)
    for i, im in enumerate(textured_sphere_images(c2ws, Ks, res, res)):
        Image.fromarray((im * 255).astype(np.uint8)).convert("RGB").save(
            os.path.join(wd, "images", f"view_{i:02d}.png"))
    return c2ws, Ks


def _set_true_focal(wd, Ks, res, mgr_cls):
    mgr = mgr_cls(wd)
    for cam_id in list(mgr.models):
        mgr.set_override(cam_id, focal=float(Ks[0][0, 0] / res))
    mgr.save()
    return mgr.propagate_to_exif()


def _files(wd, sub=""):
    d = os.path.join(wd, sub)
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))
            if os.path.isfile(os.path.join(d, f))}


def test_metadata_stage_byte_equal(tmp_path):
    wd_j, wd_t = str(tmp_path / "j"), str(tmp_path / "t")
    os.makedirs(os.path.join(wd_j, "images"))
    rng = np.random.default_rng(0)
    for name, size in (("a.png", (64, 48)), ("pano.png", (96, 48)), ("c.bmp", (40, 40))):
        Image.fromarray(rng.integers(0, 255, size[::-1] + (3,), dtype=np.uint8)).save(
            os.path.join(wd_j, "images", name))
    exif = Image.Exif()
    exif[271], exif[272] = "Canon", "EOS 5D"
    exif.get_ifd(0x8769)[0xA405] = 28  # FocalLengthIn35mmFilm
    exif.get_ifd(0x8769)[0x9003] = "2024:05:06 07:08:09"  # DateTimeOriginal
    gps = exif.get_ifd(0x8825)
    gps[1], gps[2] = "N", (52.0, 31.0, 12.5)
    gps[3], gps[4] = "W", (1.0, 2.0, 3.0)
    gps[6] = 41.5
    Image.fromarray(rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)).save(
        os.path.join(wd_j, "images", "b.jpg"), exif=exif)
    shutil.copytree(wd_j, wd_t)
    assert jpipeline.extract_metadata(wd_j) == pipeline.extract_metadata(wd_t) == 4
    assert image_processing.ImageProcessor(wd_t).list_images() == \
        jip.ImageProcessor(wd_j).list_images()
    e = json.load(open(os.path.join(wd_t, "exif", "b.jpg.exif")))
    assert e["camera"] == "Canon EOS 5D" and e["gps"]["latitude"] > 52
    assert abs(e["focal_ratio"] - 28 / 36) < 1e-9 and e["capture_time"] > 0
    assert _files(wd_t, "exif") == _files(wd_j, "exif")
    assert _files(wd_t) == _files(wd_j)  # camera_models.json

    for wd, mgr_cls in ((wd_j, jcm.CameraModelManager), (wd_t, camera_models.CameraModelManager)):
        mgr = mgr_cls(wd)
        cam = sorted(mgr.models)[0]
        mgr.set_override(cam, focal=0.9, k1=-0.05)
        mgr.set_override("never-seen", focal=1.0)
        mgr.save()
        assert mgr.propagate_to_exif() >= 1
        assert mgr.merged()["never-seen"] == {"focal": 1.0}
    desc = [{"filename": "images/a.png", "MAPLatitude": 1.5, "MAPLongitude": 2.5,
             "MAPAltitude": 3.0, "MAPCaptureTime": "2020_01_02_03_04_05_000"}]
    with open(tmp_path / "desc.json", "w") as f:
        json.dump(desc, f)
    assert jip.ImageProcessor(wd_j).apply_image_descriptions(str(tmp_path / "desc.json")) == \
        image_processing.ImageProcessor(wd_t).apply_image_descriptions(str(tmp_path / "desc.json"))
    assert _files(wd_t, "exif") == _files(wd_j, "exif")
    assert _files(wd_t) == _files(wd_j)


def _aligned_errors(wd, c2ws, parser_cls):
    p = parser_cls(wd, normalize=False)
    est = {nm: p.camtoworlds[i][:3, 3] for i, nm in enumerate(p.image_names)}
    A = np.stack([c2ws[i][:3, 3] for i in range(len(c2ws))])
    B = np.stack([est[f"view_{i:02d}.png"] for i in range(len(c2ws))])
    muA, muB = A.mean(0), B.mean(0)
    U, s, Vt = np.linalg.svd((A - muA).T @ (B - muB))
    D = np.diag([1, 1, np.sign(np.linalg.det(U @ Vt))])
    R_al = U @ D @ Vt
    scale = np.trace(np.diag(s) @ D) / ((B - muB) ** 2).sum()
    err = np.linalg.norm(scale * (B - muB) @ R_al.T + muA - A, axis=-1)
    return err / np.linalg.norm(A - muA, axis=-1).mean()


def test_run_all_cli(tmp_path, capsys):
    from splat_one_tpu.data.opensfm import Parser as JParser
    from splat_one_tpu_torch.data.opensfm import Parser

    wd = str(tmp_path / "ring")
    c2ws, Ks = _write_ring(wd)
    assert cli.main(["extract-metadata", wd, "--device", "cpu"]) == 0
    assert _set_true_focal(wd, Ks, RES, camera_models.CameraModelManager) == N_VIEWS
    capsys.readouterr()
    assert cli.main(["run-all", wd, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"): out.rindex("}") + 1])
    assert report["n_images"] == N_VIEWS, report
    with np.load(os.path.join(wd, "features", "view_00.png.features.npz")) as z:
        assert set(z.files) == {"xys", "descriptors", "scores", "valid", "bearings", "width",
                                "height", "angular_res"}
        assert z["valid"].sum() > 300 and z["descriptors"].shape == (2048, 128)
    err = _aligned_errors(wd, c2ws, Parser)
    assert len(err) == N_VIEWS
    assert np.median(err) < 0.08 and err.max() < 0.15, err
    # the JAX package continues the port's workdir
    tracks = open(os.path.join(wd, "tracks.json"), "rb").read()
    jpipeline.create_tracks(wd)
    assert open(os.path.join(wd, "tracks.json"), "rb").read() == tracks
    assert JParser(wd, normalize=False).camtoworlds.shape == (N_VIEWS, 4, 4)


def test_masks_filter_features(tmp_path):
    import scipy.ndimage as ndi

    wd = str(tmp_path)
    os.makedirs(os.path.join(wd, "images"))
    rng = np.random.default_rng(0)
    img = ndi.gaussian_filter(rng.uniform(size=(96, 128)).astype(np.float32) * 255, 1.5)
    img = ((img - img.min()) / (img.max() - img.min()) * 255).astype(np.uint8)
    Image.fromarray(img).convert("RGB").save(os.path.join(wd, "images", "a.png"))
    pipeline.extract_metadata(wd)
    pipeline.detect_features(wd, max_keypoints=512, feature_process_size=128, device="cpu")
    with np.load(os.path.join(wd, "features", "a.png.features.npz")) as z:
        before = z["xys"][z["valid"]]
    mask = np.full((96, 128), 255, np.uint8)
    mask[:, 64:] = 0  # the right half masked out
    os.makedirs(os.path.join(wd, "masks"))
    Image.fromarray(mask).save(os.path.join(wd, "masks", "a.png.png"))
    pipeline.detect_features(wd, max_keypoints=512, feature_process_size=128, device="cpu")
    with np.load(os.path.join(wd, "features", "a.png.features.npz")) as z:
        xys = z["xys"][z["valid"]]
    assert (before[:, 0] >= 64).sum() > 5  # the mask had keypoints to drop
    assert len(xys) > 5 and (xys[:, 0].astype(int) < 64).all()
    assert len(xys) == (before[:, 0].astype(int) < 64).sum()


def test_device_default_and_later_slices(tmp_path, capsys):
    wd = str(tmp_path)
    os.makedirs(os.path.join(wd, "images"))
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(os.path.join(wd, "images", "a.png"))
    assert cli.main(["extract-metadata", wd]) == 0  # host only
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["detect-features", wd])
        with pytest.raises(RuntimeError, match="CUDA"):
            pipeline.reconstruct(wd)
    cases = [
        (["detect-features", wd, "--feature-type", "ORB"], "Slice F2"),
        (["detect-features", wd, "--feature-type", "AKAZE"], "Slice F2"),
        (["detect-features", wd, "--feature-type", "SURF"], "Slice F2"),
        (["detect-features", wd, "--feature-type", "ALIKED"], "Slice G"),
        (["match-features", wd, "--matching-type", "lightglue"], "Slice G"),
        (["reconstruct", wd, "--live-viewer-port", "8765"], "Slice H"),
        (["run-all", wd, "--live-viewer-port", "8765"], "Slice H"),
        (["create-masks", wd], "Slice G"),
        (["resize", wd, "--max-dim", "16"], "Slice H"),
    ]
    for argv, slice_name in cases:
        capsys.readouterr()
        assert cli.main(argv + (["--device", "cpu"] if argv[0] in cli.SFM_COMMANDS else [])) != 0
        assert slice_name in capsys.readouterr().err, argv
