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
- The SfM subcommands run on CUDA by default (they refuse here); ORB,
  AKAZE, SURF and ALIKED features and LightGlue matching run through the
  CLI and write their files; so do the app shell's subcommands
  (``visualize-features``, ``visualize-matches``, ``resize``,
  ``restore-images``, ``mask-ui`` through HTTP, ``run-all`` /
  ``reconstruct --live-viewer-port`` with their ``/state``).
- ``cli run-all --live-viewer-port``: the viewer's final ``/state`` holds
  one camera per registered view and the reconstruction's points.
- The port's ``build_parser()`` has each of the JAX CLI's 15 subcommands
  with its options (names, defaults, choices, required) and parses an
  argv that sets every option into JAX's values.
"""

import json
import os
import shutil
import socket
import threading
import time
import urllib.error
import urllib.request

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


def _aligned_errors(wd, c2ws, parser_cls, names=None):
    """Centre errors after the similarity alignment, as fractions of the
    spread; ``names`` pairs a subset of views with ``c2ws`` (default: all
    the ring's views)."""
    p = parser_cls(wd, normalize=False)
    est = {nm: p.camtoworlds[i][:3, 3] for i, nm in enumerate(p.image_names)}
    names = names or [f"view_{i:02d}.png" for i in range(len(c2ws))]
    A = np.stack([c2ws[i][:3, 3] for i in range(len(c2ws))])
    B = np.stack([est[nm] for nm in names])
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
    port = _free_port()
    assert cli.main(["run-all", wd, "--live-viewer-port", str(port), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    report = json.loads(out[out.index("{"): out.rindex("}") + 1])
    assert report["n_images"] == N_VIEWS, report
    # the live viewer keeps serving its last snapshot: every view registered
    assert f"live reconstruction view: http://localhost:{port}" in out
    state = json.loads(_get(f"http://127.0.0.1:{port}/state"))
    assert len(state["cams"]) == N_VIEWS and len(state["points"]) > 100
    assert all(np.isfinite(c).all() for c in state["cams"])
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


def test_device_default_and_later_slices(tmp_path, capsys, monkeypatch):
    wd = str(tmp_path)
    os.makedirs(os.path.join(wd, "images"))
    Image.fromarray(np.zeros((32, 32, 3), np.uint8)).save(os.path.join(wd, "images", "a.png"))
    assert cli.main(["extract-metadata", wd]) == 0  # host only
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["detect-features", wd])
        for argv in (["create-masks", wd], ["estimate-depth", wd]):
            with pytest.raises(RuntimeError, match="CUDA"):
                cli.main(argv)
        with pytest.raises(RuntimeError, match="CUDA"):
            pipeline.reconstruct(wd)
    # the detectors and the matcher of Slices F2 / G now run and write
    wd2 = str(tmp_path / "tex")
    _write_ring(wd2, n=2, res=96)
    assert cli.main(["extract-metadata", wd2]) == 0
    feat = os.path.join(wd2, "features", "view_00.png.features.npz")
    for ft in ("ORB", "AKAZE", "SURF", "ALIKED"):
        if os.path.exists(feat):
            os.remove(feat)
        assert cli.main(["detect-features", wd2, "--feature-type", ft, "--max-keypoints",
                         "128", "--device", "cpu"]) == 0, ft
        with np.load(feat) as z:
            assert z["descriptors"].shape[0] == 128 and z["bearings"].shape == (128, 3), ft
    assert cli.main(["match-features", wd2, "--matching-type", "lightglue", "--device",
                     "cpu"]) == 0
    assert os.path.exists(os.path.join(wd2, "matches", "matches.json"))
    # the Masks stage of Slice G runs and writes masks/ (the classical
    # predictor without a checkpoint)
    with open(os.path.join(wd2, "masks_clicks.json"), "w") as f:
        json.dump({"view_00.png": {"points": [[48, 48], [2, 2]], "labels": [1, 0]}}, f)
    assert cli.main(["create-masks", wd2, "--device", "cpu"]) == 0
    m = np.asarray(Image.open(os.path.join(wd2, "masks", "view_00.png.png")))
    assert m.shape == (96, 96) and m[48, 48] == 0 and m[2, 2] == 255
    # the app shell's subcommands, once refused, run and write their files
    with open(os.path.join(wd2, "matches", "matches.json"), "w") as f:
        json.dump({"view_00.png|view_01.png": [[i, 2 * i] for i in range(20)]}, f)
    assert cli.main(["visualize-features", wd2]) == 0
    assert sorted(os.listdir(os.path.join(wd2, "previews", "features"))) == [
        "view_00.png.png", "view_01.png.png"]
    assert cli.main(["visualize-matches", wd2, "view_01.png", "view_00.png"]) == 0
    assert Image.open(os.path.join(wd2, "previews", "matches_view_01.png_view_00.png.png")
                      ).size == (192, 96)
    originals = _files(wd2, "images")
    assert cli.main(["resize", wd2, "--max-dim", "48"]) == 0
    assert _files(wd2, "images_org") == originals
    assert Image.open(os.path.join(wd2, "images", "view_00.png")).size == (48, 48)
    assert cli.main(["restore-images", wd2]) == 0
    assert _files(wd2, "images") == originals
    os.remove(os.path.join(wd2, "masks", "view_00.png.png"))
    assert _mask_ui_save(monkeypatch, wd2, {"name": "view_00.png", "points": [[48, 48], [2, 2]],
                                            "labels": [1, 0]}) == 0
    assert np.array_equal(np.asarray(Image.open(os.path.join(wd2, "masks", "view_00.png.png"))),
                          m)
    for cmd in ("run-all", "reconstruct"):  # two opposite views: nothing registers
        port = _free_port()
        assert cli.main([cmd, wd2, "--live-viewer-port", str(port), "--device", "cpu"]) == 0
        assert os.path.exists(os.path.join(wd2, "tracks.json"))
        assert os.path.exists(os.path.join(wd2, "reconstruction.json"))
        state = json.loads(_get(f"http://127.0.0.1:{port}/state"))
        assert state == {"points": [], "cams": [], "center": [0, 0, 0]}, cmd


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(url, data=None):
    req = urllib.request.Request(url, data=None if data is None else json.dumps(data).encode())
    return urllib.request.urlopen(req, timeout=60).read()


def _mask_ui_save(monkeypatch, wd, spec):
    """``cli mask-ui --device cpu`` in a thread: /save ``spec``, then stop
    the server; returns the CLI's exit code."""
    from splat_one_tpu_torch.app import mask_ui

    servers, port, rc = [], _free_port(), []
    init = mask_ui.MaskUIServer.__init__

    def record(self, *a, **kw):
        init(self, *a, **kw)
        servers.append(self)

    monkeypatch.setattr(mask_ui.MaskUIServer, "__init__", record)
    th = threading.Thread(target=lambda: rc.append(cli.main(
        ["mask-ui", wd, "--port", str(port), "--device", "cpu"])), daemon=True)
    th.start()
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                assert json.loads(_get(f"http://127.0.0.1:{port}/images"))
                break
            except urllib.error.URLError:
                assert time.monotonic() < deadline, "mask-ui did not start"
                time.sleep(0.05)
        assert _get(f"http://127.0.0.1:{port}/save", spec) == b"{}"
    finally:
        for srv in servers:
            srv.httpd.shutdown()
    th.join(timeout=30)
    assert not th.is_alive()
    servers[0].httpd.server_close()
    return rc[0]


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
    """The JAX CLI's parser, as its ``main`` builds it (stopped at
    ``parse_args``)."""
    import argparse

    from splat_one_tpu.app import cli as jcli

    box = []

    def grab(self, args=None, namespace=None):
        box.append(self)
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            jcli.main([])
    return box[0]


def _subcommands(parser):
    import argparse

    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return sub.choices


def _spec(action):
    return (tuple(action.option_strings), action.default, action.choices, action.required,
            action.type, action.nargs, type(action).__name__)


def test_cli_has_every_jax_subcommand(monkeypatch):
    jsubs = _subcommands(_jax_parser(monkeypatch))
    tsubs = _subcommands(cli.build_parser())
    assert len(jsubs) == 15
    assert set(tsubs) == set(jsubs)
    for name, jp in jsubs.items():
        jact = {a.dest: a for a in jp._actions if a.dest != "help"}
        tact = {a.dest: a for a in tsubs[name]._actions if a.dest != "help"}
        assert set(tact) - set(jact) <= {"device", "primitive"}, name
        argv = [name]
        for dest, a in jact.items():
            assert _spec(tact[dest]) == _spec(a), (name, dest)
            if not a.option_strings:
                argv.append(f"{dest}.png")
            elif a.nargs == 0:
                argv.append(a.option_strings[0])
            else:
                val = a.choices[-1] if a.choices else {int: "7", float: "0.25"}.get(a.type, "x")
                argv += [a.option_strings[0], val]
        want = vars(jp.parse_args(argv[1:]))
        got = vars(cli.build_parser().parse_args(argv))
        assert got.pop("cmd") == name
        got.pop("device", None)
        assert got.pop("primitive", "3dgs") == "3dgs"
        assert got == want, name
        if "device" in tact:
            assert tact["device"].default == "cuda"
        if "primitive" in tact:  # the viewer's 2DGS flag: 3DGS unless asked
            assert tact["primitive"].default == "3dgs"
