"""Port parity: the train stage from a workdir (``app/pipeline.train_splats``,
``Trainer.run``, ``app/cli``, ``app/viewer.serve_workdir``) against the JAX
package, on a tiny workdir the test writes: an OpenSfM
``reconstruction.json`` (one perspective camera, 12 shots on a ring, a
``reference_lla``, the GT gaussians' means as points) and 12 PNGs at
64x48 rendered by the port from that GT.

- ``train_splats`` on the CPU and the JAX package's on a copy of the
  workdir: losses within 1e-3 rel (the Trainer bar), the same alive
  counts, a checkpoint, stats, ``tb/``, ``renders/`` and ``videos/``.
- ``cli train --ckpt --compression png``: eval-only ``Trainer.run``
  writes the val stats (equal to the trained Trainer's eval), the
  trajectory frames (RGB | depth, 128x48) and the compressed planes with
  their stats.
- ``cli`` parses every subcommand as the JAX parser does (``train``,
  ``viewer`` and the SfM subcommands add ``--device``); ``train`` and
  ``viewer`` reach ``train_splats`` / ``serve_workdir`` with the JAX
  CLI's arguments; an unported subcommand exits non-zero and names its
  slice.
- ``workdir_server`` answers ``/`` and one ``/render`` from a background
  server on the CPU with a JPEG of the Trainer's size.
"""

import argparse
import dataclasses
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image
from scipy.spatial.transform import Rotation

from splat_one_tpu.app import cli as jcli
from splat_one_tpu.app import pipeline as jpipeline
from splat_one_tpu.train.config import Config as JConfig
from splat_one_tpu.train.strategy import DefaultStrategyCfg as JDefault
from splat_one_tpu_torch.app import cli, pipeline, viewer
from splat_one_tpu_torch.core.sh import rgb_to_sh
from splat_one_tpu_torch.core.transforms import invert_se3
from splat_one_tpu_torch.data.opensfm import Parser
from splat_one_tpu_torch.data.synthetic import make_gt_gaussians, ring_cameras
from splat_one_tpu_torch.render.rasterization import rasterization
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, VIEWS, N_GT = 64, 48, 12, 300
STEPS = 6
STRAT = dict(refine_start_iter=2, refine_stop_iter=100, refine_every=3, reset_every=5,
             grow_grad2d=1e-6)
# SH degree 3: what the CLI's eval-only run and the viewer assume
CFG = dict(max_steps=STEPS, eval_steps=[STEPS], save_steps=[STEPS], sh_degree=3,
           sh_degree_interval=2, capacity=512, tb_every=3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_workdir(wd):
    """An OpenSfM workdir whose images the port renders from GT gaussians."""
    os.makedirs(os.path.join(wd, "images"))
    means, quats, scales, opac, rgb = make_gt_gaussians(N_GT, seed=0)
    c2ws, Ks = ring_cameras(VIEWS, 3.0, -0.8, 60.0, W, H)
    shots = {}
    for i, c2w in enumerate(c2ws):
        w2c = np.linalg.inv(c2w)
        shots[f"shot_{i:03d}.png"] = {
            "rotation": Rotation.from_matrix(w2c[:3, :3]).as_rotvec().tolist(),
            "translation": w2c[:3, 3].tolist(), "camera": "cam"}
    rec = {"cameras": {"cam": {"projection_type": "perspective", "width": W, "height": H,
                               "focal": float(Ks[0, 0, 0]) / max(W, H), "k1": 0.0, "k2": 0.0}},
           "shots": shots,
           "points": {str(i): {"coordinates": means[i].tolist(),
                               "color": (rgb[i] * 255).astype(int).tolist()}
                      for i in range(N_GT)},
           "reference_lla": {"latitude": 35.0, "longitude": 139.0, "altitude": 10.0}}
    with open(os.path.join(wd, "reconstruction.json"), "w") as f:
        json.dump([rec], f)
    p = Parser(wd, normalize=False)  # the GT's frame
    t = torch.as_tensor
    sh0 = rgb_to_sh(t(rgb))[:, None]
    with torch.no_grad():
        for i, name in enumerate(p.image_names):
            r, _, _ = rasterization(t(means), t(quats), t(scales), t(opac), sh0,
                                    invert_se3(t(p.camtoworlds[i:i + 1])), t(p.Ks[i:i + 1]),
                                    W, H, sh_degree=0)
            img = (np.clip(r[0].numpy(), 0, 1) * 255).round().astype(np.uint8)
            Image.fromarray(img).save(os.path.join(wd, "images", name))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The workdir, trained by the port's train_splats on the CPU."""
    wd = str(tmp_path_factory.mktemp("wd") / "work")
    write_workdir(wd)
    shutil.copytree(wd, wd + "_jax")
    tr, hist = pipeline.train_splats(
        wd, Config(strategy=DefaultStrategyCfg(**STRAT), **CFG), device="cpu")
    return wd, tr, hist


def test_train_splats_tracks_jax(trained):
    wd, tr, hist = trained
    jt, hist_j = jpipeline.train_splats(wd + "_jax", JConfig(strategy=JDefault(**STRAT), **CFG))
    assert tr.result_dir == os.path.join(wd, "results")
    assert tr.n_images == VIEWS and (tr.width, tr.height) == (W, H)
    np.testing.assert_array_equal(tr.scene.camtoworlds, jt.scene.camtoworlds)
    np.testing.assert_array_equal(tr.scene.images, jt.scene.images)
    # run() logs the last step (log_every 100), as the JAX run does
    assert [h["step"] for h in hist] == [h["step"] for h in hist_j] == [STEPS]
    assert np.isfinite(hist[0]["loss"])
    np.testing.assert_allclose(hist[0]["loss"], hist_j[0]["loss"], rtol=1e-3)
    assert hist[0]["num_GS"] == hist_j[0]["num_GS"] != N_GT  # the refines changed it
    res = os.path.join(wd, "results")
    for sub in ("ckpts", "stats", "renders", "videos", "tb"):
        assert os.path.isdir(os.path.join(res, sub)), sub
    assert os.path.exists(os.path.join(res, "ckpts", f"ckpt_{STEPS}.npz"))
    assert os.path.exists(os.path.join(res, "stats", f"val_step{STEPS:04d}.json"))
    assert any(f.startswith("events.out") for f in os.listdir(os.path.join(res, "tb")))
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            pipeline.train_splats(wd, Config(**CFG))


def test_cli_eval_only_run(trained):
    """cli train --ckpt --compression png: eval, trajectory, compression."""
    wd, tr, _ = trained
    res = os.path.join(wd, "results")
    want = tr.eval(STEPS, stage="check")
    ckpt = os.path.join(res, "ckpts", f"ckpt_{STEPS}.npz")
    assert cli.main(["train", wd, "--ckpt", ckpt, "--compression", "png",
                     "--device", "cpu"]) == 0
    with open(os.path.join(res, "stats", f"val_step{STEPS:04d}.json")) as f:
        got = json.load(f)
    assert got["psnr"] == pytest.approx(want["psnr"], rel=1e-6)
    assert got["ssim"] == pytest.approx(want["ssim"], rel=1e-6)
    frames = sorted(os.listdir(os.path.join(res, "videos", f"traj_{STEPS}")))
    # 12 views trimmed to 2: the interpolated path has 60 frames
    assert len(frames) == 60 and frames[0] == "0000.png"
    im = Image.open(os.path.join(res, "videos", f"traj_{STEPS}", frames[7]))
    assert im.size == (2 * W, H) and im.mode == "RGB"
    comp = os.listdir(os.path.join(res, "compression"))
    assert "meta.json" in comp and "means_hi.png" in comp and "shN_14.png" in comp
    with open(os.path.join(res, "stats", f"compress_step{STEPS:04d}.json")) as f:
        c = json.load(f)
    assert c["num_GS"] == tr.state.alive.sum().item() and c["psnr"] > 5


def _jax_namespace(argv, monkeypatch):
    """The namespace the JAX CLI parses from argv (its main stops there)."""
    seen = {}
    parse = argparse.ArgumentParser.parse_args

    class Parsed(Exception):
        pass

    def capture(self, args=None, namespace=None):
        seen["ns"] = parse(self, args, namespace)
        raise Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(Parsed):
            jcli.main(argv)
    return vars(seen["ns"])


ARGVS = [
    ["extract-metadata", "w"], ["detect-features", "w", "--feature-type", "ORB"],
    ["match-features", "w", "--lowes-ratio", "0.7", "--matching-type", "flann"],
    ["create-tracks", "w"], ["reconstruct", "w", "--bundle-use-gps"], ["run-all", "w"],
    ["create-masks", "w", "--clicks", "c.json"], ["resize", "w", "--max-dim", "512"],
    ["restore-images", "w"], ["mask-ui", "w"], ["estimate-depth", "w", "--equirect"],
    ["visualize-features", "w"], ["visualize-matches", "w", "a.jpg", "b.jpg"],
    ["train", "w"], ["train", "w", "--max-steps", "7", "--strategy", "mcmc", "--max-images",
                     "5", "--data-factor", "2", "--ckpt", "c.npz", "--compression", "png"],
    ["viewer", "w"], ["viewer", "w", "--port", "9001", "--ckpt", "c.npz"],
]


def test_cli_parses_as_jax(monkeypatch, capsys, tmp_path):
    for argv in ARGVS:
        ns = vars(cli.build_parser().parse_args(argv))
        if argv[0] in ("train", "viewer", "create-masks", "estimate-depth") + cli.SFM_COMMANDS:
            assert ns.pop("device") == "cuda"
        assert ns == _jax_namespace(argv, monkeypatch), argv

    # train and viewer reach the stage with the JAX CLI's arguments
    calls = {}
    monkeypatch.setattr(jpipeline, "train_splats",
                        lambda wd, cfg, max_images=None: calls.update(j=(wd, cfg, max_images))
                        or (None, []))
    monkeypatch.setattr(pipeline, "train_splats",
                        lambda wd, cfg, max_images=None, device="cuda":
                        calls.update(t=(wd, cfg, max_images, device)) or (None, []))
    argv = ARGVS[14]
    jcli.main(argv)
    assert cli.main(argv + ["--device", "cpu"]) == 0
    (wd_j, cfg_j, mi_j), (wd_t, cfg_t, mi_t, dev) = calls["j"], calls["t"]
    assert (wd_t, mi_t, dev) == (wd_j, mi_j, "cpu")
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    assert type(cfg_t.strategy).__name__ == type(cfg_j.strategy).__name__ == "MCMCStrategyCfg"
    monkeypatch.setattr("splat_one_tpu.app.viewer.serve_workdir",
                        lambda wd, port, ckpt: calls.update(vj=(wd, port, ckpt)))
    monkeypatch.setattr(viewer, "serve_workdir",
                        lambda wd, port, ckpt, device: calls.update(vt=(wd, port, ckpt, device)))
    jcli.main(ARGVS[16])
    assert cli.main(ARGVS[16]) == 0
    assert calls["vt"] == calls["vj"] + ("cuda",)

    # an unported subcommand exits non-zero and names the slice that ports it
    capsys.readouterr()
    assert cli.main(["resize", "w", "--max-dim", "512"]) != 0
    assert "Slice H" in capsys.readouterr().err
    # the Depth stage of Slice G runs in its own process and writes depth/
    # (the seeded compact vits without a checkpoint)
    wd = tmp_path / "depth_wd"
    (wd / "images").mkdir(parents=True)
    Image.fromarray(np.full((24, 32, 3), 128, np.uint8)).save(wd / "images" / "a.png")
    proc = subprocess.run([sys.executable, "-m", "splat_one_tpu_torch.app.cli",
                           "estimate-depth", str(wd), "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert np.load(wd / "depth" / "a_depth.npy").shape == (24, 32)
    assert (wd / "depth" / "a_depth.png").exists()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_workdir_server_answers_render(trained):
    wd, tr, _ = trained
    srv = viewer.workdir_server(wd, port=_free_port(), device="cpu")
    srv.serve_background()
    try:
        url = f"http://127.0.0.1:{srv.port}"
        with urllib.request.urlopen(url + "/", timeout=60) as r:
            assert r.status == 200 and b"<img" in r.read()
        with urllib.request.urlopen(url + "/render?x=0&y=-0.5&z=-3&yaw=0&pitch=0.1",
                                    timeout=120) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/jpeg"
            img = Image.open(io.BytesIO(r.read()))
        # the Trainer's size, not the server's 640x480 page and camera
        assert img.size == (W, H) and img.mode == "RGB"
    finally:
        srv.shutdown()
    assert viewer.latest_checkpoint(wd).endswith(f"ckpt_{STEPS}.npz")
