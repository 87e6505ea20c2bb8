"""Workdir pipeline stages: counterpart of ``splat_one_tpu/app/pipeline.py``.

images -> SfM -> ``reconstruction.json`` -> splats, over the same workdir
files as the JAX package, so either package can continue a workdir the
other began:

  images/                     input images
  exif/<img>.exif             per-image metadata JSON
  camera_models.json          (+ camera_models_overrides.json)
  features/<img>.features.npz xys, descriptors, scores, valid, bearings,
                              width, height, angular_res
  matches/matches.json        verified pairs "a|b" -> [[fa, fb], ...]
  tracks.json                 [{image index: feature}, ...]
  reconstruction.json         OpenSfM-compatible cameras/shots/points
  masks_clicks.json           {image: {"points": [[x, y], ...], "labels": [1, 0, ...]}}
  masks/<img>.png             inverted masks (``create_masks``), read by detect_features
  depth/<img>_depth.npy|png   relative depth maps (``estimate_depth``)
  previews/                   keypoint and match previews (``visualize_*``)

The SfM stages take every detector of the JAX package (SIFT, HAHOG, ORB,
AKAZE, SURF, ALIKED) and every matcher (brute force, FLANN, LightGlue);
``reconstruct`` can serve the live reconstruction viewer. Every stage
with a network or a solver runs on CUDA unless ``device="cpu"`` is
passed; the previews are PIL on the host.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from splat_one_tpu_torch.utils.device import resolve as resolve_device

ProgressFn = Optional[Callable[[int, int], None]]

FEATURE_TYPES = ("SIFT", "HAHOG", "ORB", "AKAZE", "SURF", "ALIKED")


def _exif_dir(workdir):
    d = os.path.join(workdir, "exif")
    os.makedirs(d, exist_ok=True)
    return d


def _images(workdir):
    from splat_one_tpu_torch.app.image_processing import ImageProcessor

    return ImageProcessor(workdir).list_images()


def extract_metadata(workdir: str, progress: ProgressFn = None) -> int:
    """images/ -> exif/*.exif + camera_models.json (host only)."""
    from splat_one_tpu_torch.app import exif as exif_mod

    images = _images(workdir)
    models: Dict[str, Dict] = {}
    mp = os.path.join(workdir, "camera_models.json")
    if os.path.exists(mp):
        with open(mp) as f:
            models = json.load(f)
    for i, name in enumerate(images):
        e = exif_mod.extract_exif(os.path.join(workdir, "images", name))
        cam_id = exif_mod.camera_id_from_exif(e)
        e["camera_id"] = cam_id
        if cam_id not in models:
            models[cam_id] = exif_mod.default_camera_model(e)
        with open(os.path.join(_exif_dir(workdir), name + ".exif"), "w") as f:
            json.dump(e, f, indent=2)
        if progress:
            progress(i + 1, len(images))
    with open(mp, "w") as f:
        json.dump(models, f, indent=2)
    return len(images)


def _load_exif(workdir, name):
    with open(os.path.join(workdir, "exif", name + ".exif")) as f:
        return json.load(f)


def _camera_for(workdir, exif):
    with open(os.path.join(workdir, "camera_models.json")) as f:
        models = json.load(f)
    ovp = os.path.join(workdir, "camera_models_overrides.json")
    if os.path.exists(ovp):
        with open(ovp) as f:
            for k, v in json.load(f).items():
                if k in models:
                    models[k].update(v)
    return models[exif["camera_id"]]


def _load_features(workdir, images):
    out = {}
    for name in images:
        with np.load(os.path.join(workdir, "features", name + ".features.npz")) as z:
            out[name] = {k: z[k] for k in z.files}
    return out


def detect_features(
    workdir: str,
    max_keypoints: int = 2048,
    feature_process_size: int = 1024,
    contrast_threshold: float = 0.01,
    feature_type: str = "SIFT",
    aliked_checkpoint: str | None = None,
    akaze_omax: int = 4,
    akaze_dthreshold: float = 0.001,
    akaze_descriptor: str = "MSURF",
    akaze_descriptor_size: int = 0,
    akaze_descriptor_channels: int = 3,
    akaze_kcontrast_percentile: float = 0.7,
    akaze_use_isotropic_diffusion: bool = False,
    surf_hessian_threshold: float = 3000.0,
    surf_n_octaves: int = 4,
    surf_n_octavelayers: int = 2,
    surf_upright: bool = False,
    hahog_peak_threshold: float = 1e-5,
    hahog_edge_threshold: float = 10.0,
    progress: ProgressFn = None,
    device="cuda",
) -> int:
    """images/ -> features/<img>.features.npz: keypoints in original
    pixels, descriptors, scores, validity (keypoints inside a
    ``masks/<img>.png`` region of value <= 127 dropped), bearings from the
    camera model and the angular size of one detection pixel.

    ``feature_type``: SIFT (the DoG detector, default), HAHOG (Hessian
    detector + HOG descriptor; ``hahog_*``), ORB (FAST + rotated BRIEF),
    AKAZE (FED nonlinear scale space + Hessian detector + M-SURF / M-LDB;
    ``akaze_*``), SURF (integral-image fast-Hessian + M-SURF; ``surf_*``)
    or ALIKED (learned: the checkpoint-faithful network when
    ``aliked_checkpoint`` is a converted npz in the official schema, else
    the compact tier)."""
    from PIL import Image

    from splat_one_tpu_torch.core import cameras as cam_mod

    ft = feature_type.upper()
    if ft not in FEATURE_TYPES:
        raise ValueError(f"feature_type {feature_type!r}: expected one of "
                         + " | ".join(FEATURE_TYPES))
    dev = resolve_device(device)
    extract = _extractor(ft, dev, max_keypoints, contrast_threshold, aliked_checkpoint,
                         dict(omax=akaze_omax, dthreshold=akaze_dthreshold,
                              descriptor=akaze_descriptor,
                              descriptor_size=akaze_descriptor_size,
                              descriptor_channels=akaze_descriptor_channels,
                              kcontrast_percentile=akaze_kcontrast_percentile,
                              isotropic=akaze_use_isotropic_diffusion),
                         dict(hessian_threshold=surf_hessian_threshold,
                              n_octaves=surf_n_octaves, n_layers=surf_n_octavelayers,
                              upright=surf_upright),
                         dict(peak_threshold=hahog_peak_threshold,
                              edge_threshold=hahog_edge_threshold))
    images = _images(workdir)
    fdir = os.path.join(workdir, "features")
    os.makedirs(fdir, exist_ok=True)
    for i, name in enumerate(images):
        exif = _load_exif(workdir, name)
        cam = _camera_for(workdir, exif)
        img = Image.open(os.path.join(workdir, "images", name)).convert("L")
        W0, H0 = img.size
        scale = 1.0
        if max(W0, H0) > feature_process_size:
            scale = feature_process_size / max(W0, H0)
            img = img.resize((int(W0 * scale), int(H0 * scale)))
        feats = extract(torch.as_tensor(np.asarray(img).astype(np.float32) / 255.0, device=dev))
        valid = feats.valid.cpu().numpy()
        xys = feats.xys.cpu().numpy() / scale  # original pixel coords
        # masks/<img>.png (0 = masked out, OpenSfM's convention): drop
        # keypoints inside masked regions so moving objects don't anchor SfM
        mask_path = os.path.join(workdir, "masks", name + ".png")
        if os.path.exists(mask_path):
            m = np.asarray(Image.open(mask_path).convert("L"))
            xi = np.clip(xys[:, 0].astype(int), 0, m.shape[1] - 1)
            yi = np.clip(xys[:, 1].astype(int), 0, m.shape[0] - 1)
            valid = valid & (m[yi, xi] > 127)
        proc_size = max(W0, H0) * scale
        if cam["projection_type"] == "spherical":
            K = np.eye(3, dtype=np.float32)
            model = "spherical"
            # one detection pixel of angle: 2 pi over the processed width
            ang_res = 2.0 * np.pi / max(W0 * scale, 1.0)
        else:
            f_norm = cam.get("focal")
            if f_norm is None:
                f_norm = exif.get("focal_ratio", 0.85)
            f = f_norm * max(W0, H0)
            K = np.array([[f, 0, W0 / 2], [0, f, H0 / 2], [0, 0, 1]], np.float32)
            model = "pinhole"
            ang_res = 1.0 / max(f_norm * proc_size, 1.0)
        bearings = cam_mod.unproject(torch.as_tensor(xys, device=dev),
                                     torch.as_tensor(K, device=dev), W0, H0, model)
        np.savez(
            os.path.join(fdir, name + ".features.npz"),
            xys=xys,
            descriptors=feats.descriptors.cpu().numpy(),
            scores=feats.scores.cpu().numpy(),
            valid=valid,
            bearings=bearings.cpu().numpy(),
            width=W0,
            height=H0,
            angular_res=np.float32(ang_res),
        )
        if progress:
            progress(i + 1, len(images))
    return len(images)


def _extractor(ft, dev, max_keypoints, contrast_threshold, aliked_checkpoint, akaze_kw,
               surf_kw, hahog_kw):
    """The detector of ``feature_type`` ``ft`` as a function of the
    [H, W] image tensor (ALIKED's weights loaded once, on ``dev``)."""
    from splat_one_tpu_torch.sfm import features as F

    if ft == "SURF":
        from splat_one_tpu_torch.sfm.surf import extract_surf

        return lambda a: extract_surf(a, max_keypoints=max_keypoints, **surf_kw)
    if ft == "AKAZE":
        from splat_one_tpu_torch.sfm.akaze import extract_akaze

        return lambda a: extract_akaze(a, max_keypoints=max_keypoints, **akaze_kw)
    if ft == "ORB":
        from splat_one_tpu_torch.sfm.orb import extract_orb

        return lambda a: extract_orb(a, max_keypoints=max_keypoints)
    if ft == "ALIKED":
        from splat_one_tpu_torch.models import aliked_tpu

        params = aliked_tpu.load_aliked(aliked_checkpoint, device=dev)
        fn = (aliked_tpu.extract_aliked_ckpt if aliked_tpu.is_faithful(params)
              else aliked_tpu.extract_aliked)
        return lambda a: fn(params, a, max_keypoints=max_keypoints)
    if ft == "HAHOG":
        return lambda a: F.extract_hahog(a, max_keypoints=max_keypoints, **hahog_kw)
    return lambda a: F.extract_features(a, max_keypoints=max_keypoints,
                                        contrast_threshold=contrast_threshold)


def _gps_positions(workdir, images):
    """Per image [east, north, altitude] in one UTM zone, or None where an
    image has no fix (inf rows) / no image has one."""
    from splat_one_tpu_torch.data.opensfm import latlon_to_utm

    pos, zone = [], None  # one zone for the whole set
    for name in images:
        g = _load_exif(workdir, name).get("gps", {})
        if "latitude" in g:
            e, n, zone = latlon_to_utm(g["latitude"], g["longitude"], zone)
            pos.append([e, n, g.get("altitude", 0.0)])
        else:
            pos.append([np.inf, np.inf, np.inf])
    pos = np.asarray(pos)
    return pos if np.isfinite(pos).any() else None


def match_features(
    workdir: str,
    lowes_ratio: float = 0.8,
    order_neighbors: int = 0,
    gps_neighbors: int = 0,
    vlad_neighbors: int = 0,
    matching_type: str = "bruteforce",
    lightglue_checkpoint: str | None = None,
    progress: ProgressFn = None,
    device="cuda",
) -> int:
    """features/ -> matches/matches.json (verified pairs).

    ``matching_type``: "bruteforce" (mutual-NN + Lowe ratio, batched over
    pairs on the device; "flann" is the same exact path) or "lightglue"
    (the official forward when ``lightglue_checkpoint`` or
    ``$SPLAT_LIGHTGLUE_CKPT`` names a converted checkpoint, its matches
    kept where both keypoints are valid; else the trainable tier).
    Verification by 8-point RANSAC with a resolution-aware threshold (1.6
    detection pixels of angle, at most 0.008 rad), its draws from a
    generator seeded 0."""
    from splat_one_tpu_torch.sfm import matching as M

    mt = matching_type.replace("-", "").replace("_", "").lower()
    if mt not in ("bruteforce", "flann", "lightglue"):
        raise ValueError(f"matching_type {matching_type!r}: expected "
                         "Brute-Force | FLANN | LIGHTGLUE")
    dev = resolve_device(device)
    images = _images(workdir)
    feats = _load_features(workdir, images)
    gps = _gps_positions(workdir, images) if gps_neighbors > 0 else None
    descs = [feats[n]["descriptors"] for n in images]
    valids = [feats[n]["valid"] for n in images]
    pairs = M.pairs_to_match(
        len(images), order_neighbors=order_neighbors,
        gps_positions=gps, gps_neighbors=gps_neighbors,
        descriptors=descs if vlad_neighbors > 0 else None,
        desc_valids=valids if vlad_neighbors > 0 else None,
        vlad_neighbors=vlad_neighbors, device=dev)
    if mt == "lightglue":
        ckpt = lightglue_checkpoint or os.environ.get("SPLAT_LIGHTGLUE_CKPT")
        raw = _lightglue_matches(feats, images, pairs, ckpt, progress, dev)
    else:
        raw = M.match_pairs_batched(descs, valids, pairs, ratio=lowes_ratio,
                                    progress_callback=progress, device=dev)
    ang = [float(feats[n]["angular_res"]) for n in images if "angular_res" in feats[n]]
    thr_match = min(1.6 * float(np.median(ang)), 0.008) if ang else 0.008
    bearings = [feats[n]["bearings"] for n in images]
    filtered = M.robust_filter_matches_batched(raw, bearings, threshold=thr_match, device=dev)
    out = {f"{images[i]}|{images[j]}": fm.tolist()
           for (i, j), fm in filtered.items() if len(fm)}
    os.makedirs(os.path.join(workdir, "matches"), exist_ok=True)
    with open(os.path.join(workdir, "matches", "matches.json"), "w") as f:
        json.dump(out, f)
    return len(out)


def _lightglue_matches(feats, images, pairs, checkpoint, progress, dev):
    """Putative matches {(i, j): [M, 2]} of each pair by LightGlue, pair by
    pair on ``dev``."""
    from splat_one_tpu_torch.models import lightglue_tpu as LG

    params = LG.load_lightglue(checkpoint, desc_dim=feats[images[0]]["descriptors"].shape[1],
                               device=dev)
    faithful = LG.is_faithful(params)
    raw = {}
    for npair, (i, j) in enumerate(pairs):
        fi, fj = feats[images[i]], feats[images[j]]
        size_i = (int(fi["width"]), int(fi["height"]))
        size_j = (int(fj["width"]), int(fj["height"]))
        if faithful:
            scores = LG.lightglue_forward_ckpt(params, fi["xys"], fj["xys"], fi["descriptors"],
                                               fj["descriptors"], size_i, size_j)
            idx_b, ok = LG.filter_matches_ckpt(scores)
            ok = ok & fi["valid"] & fj["valid"][idx_b]
        else:
            idx_b, ok = LG.match_lightglue(params, fi["descriptors"], fj["descriptors"],
                                           fi["xys"], fj["xys"], size_i, size_j,
                                           fi["valid"], fj["valid"])
        raw[(i, j)] = np.stack([np.flatnonzero(ok), idx_b[ok]], axis=1)
        if progress:
            progress(npair + 1, len(pairs))
    return raw


def _load_matches(workdir, images):
    idx_of = {n: i for i, n in enumerate(images)}
    with open(os.path.join(workdir, "matches", "matches.json")) as f:
        raw = json.load(f)
    out = {}
    for k, m in raw.items():
        a, b = k.split("|")
        out[(idx_of[a], idx_of[b])] = np.asarray(m, np.int64).reshape(-1, 2)
    return out


def create_tracks(workdir: str, min_track_length: int = 2) -> int:
    """matches/ -> tracks.json (host only)."""
    from splat_one_tpu_torch.sfm import tracks as T

    images = _images(workdir)
    matches = _load_matches(workdir, images)
    n_feats = [len(f["valid"]) for f in _load_features(workdir, images).values()]
    tracks, _ = T.build_tracks(matches, n_feats, min_track_length)
    with open(os.path.join(workdir, "tracks.json"), "w") as f:
        json.dump([{str(img): int(ft) for img, ft in tr.items()} for tr in tracks], f)
    return len(tracks)


def reconstruct(workdir: str, progress: ProgressFn = None,
                live_viewer_port: int = 0,
                bundle_use_gps: bool = False,
                gps_sd_m: float = 5.0,
                device="cuda") -> Dict:
    """tracks + features -> incremental SfM -> reconstruction.json
    (OpenSfM-compatible; ``data.opensfm.Parser`` reads it). The
    reprojection-outlier threshold is 1.3 detection pixels of angle.
    ``bundle_use_gps`` converts EXIF GPS to a local frame (UTM, recentred)
    and puts centre priors in every global bundle. ``progress`` is accepted
    for the CLI's sake. ``live_viewer_port`` > 0 serves the live
    point-cloud / camera view (``app.recon_viewer``) while reconstruction
    runs; its daemon thread keeps serving after the stage returns, as in
    the JAX package."""
    from splat_one_tpu_torch.sfm import reconstruct as RC

    dev = resolve_device(device)
    images = _images(workdir)
    with open(os.path.join(workdir, "tracks.json")) as f:
        tracks = [{int(k): int(v) for k, v in tr.items()} for tr in json.load(f)]
    feats = _load_features(workdir, images)
    bearings = [feats[n]["bearings"].astype(np.float32) for n in images]
    ang_res = [float(feats[n]["angular_res"]) for n in images if "angular_res" in feats[n]]
    counts = {k: len(m) for k, m in _load_matches(workdir, images).items()}
    snapshot = None
    if live_viewer_port:
        from splat_one_tpu_torch.app.recon_viewer import LiveReconViewer

        viewer = LiveReconViewer(port=live_viewer_port)
        print(f"live reconstruction view: {viewer.serve_background()}")
        snapshot = viewer.update
    gps_positions = None
    cfg = RC.ReconstructConfig()
    if ang_res:
        thr = 1.3 * float(np.median(ang_res))
        cfg = RC.ReconstructConfig(outlier_threshold=thr,
                                   ransac_threshold=min(1.3 * thr, 0.006))
    if bundle_use_gps:
        pos = _gps_positions(workdir, images)
        fixes = {} if pos is None else {
            i: p for i, p in enumerate(pos) if np.isfinite(p).all()}
        if len(fixes) >= 3:
            origin = np.mean(list(fixes.values()), axis=0)
            gps_positions = {i: (p - origin).astype(np.float32) for i, p in fixes.items()}
            cfg = RC.ReconstructConfig(bundle_use_gps=True, gps_sd_m=gps_sd_m)
    rec = RC.incremental_reconstruct(bearings, tracks, counts, cfg=cfg, snapshot=snapshot,
                                     gps_positions=gps_positions, device=dev)

    cameras, shots = {}, {}
    for img_idx, pose in rec.poses.items():
        name = images[img_idx]
        exif = _load_exif(workdir, name)
        cam_key = exif["camera_id"]
        cameras[cam_key] = _camera_for(workdir, exif)
        shots[name] = {"rotation": np.asarray(pose[:3]).tolist(),
                       "translation": np.asarray(pose[3:]).tolist(),
                       "camera": cam_key}
    points = {str(tid): {"coordinates": np.asarray(xyz).tolist(), "color": [180, 180, 180]}
              for tid, xyz in rec.points.items()}
    with open(os.path.join(workdir, "reconstruction.json"), "w") as f:
        json.dump([{"cameras": cameras, "shots": shots, "points": points}], f)
    return rec.report


def train_splats(workdir: str, cfg=None, max_images: Optional[int] = None, device="cuda"):
    """Parse the workdir's OpenSfM reconstruction (factor 1, as the JAX
    stage does whatever ``Config.data_factor`` says), load its images and
    ``Trainer.run`` with results under ``<workdir>/results``. Returns
    ``(trainer, history)``: the training history, or the eval stats when
    ``cfg.ckpt`` is set. Runs on CUDA unless ``device="cpu"``."""
    from splat_one_tpu_torch.data.opensfm import Parser, to_scene_data
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.trainer import Trainer

    dev = resolve_device(device)
    parser = Parser(workdir)
    scene = to_scene_data(parser, max_images=max_images)
    cfg = cfg or Config()
    cfg.result_dir = os.path.join(workdir, "results")
    cfg.camera_model = scene.camera_model
    trainer = Trainer(cfg, scene, device=dev)
    return trainer, trainer.run()


def create_masks(workdir: str, clicks_path: Optional[str] = None,
                 checkpoint: Optional[str] = None, progress: ProgressFn = None,
                 device="cuda") -> int:
    """The Masks stage: for each image of ``masks_clicks.json`` (or
    ``clicks_path``) the predictor of ``segmentation.build_predictor``
    (SAM 2.1, the compact net or the classical region grower, by the
    checkpoint) on its clicks, the best-scoring mask written inverted to
    ``masks/<img>.png``. Returns the masks written (0 without a clicks
    file). The learned predictors run on CUDA unless ``device="cpu"``;
    the classical one is numpy on the host, and CUDA must be there all the
    same where it was asked for."""
    from PIL import Image

    from splat_one_tpu_torch.models.segmentation import build_predictor, save_mask

    dev = resolve_device(device)
    clicks_path = clicks_path or os.path.join(workdir, "masks_clicks.json")
    if not os.path.exists(clicks_path):
        return 0
    with open(clicks_path) as f:
        clicks = json.load(f)
    pred = build_predictor(checkpoint, device=dev)
    n = 0
    for i, (name, spec) in enumerate(sorted(clicks.items())):
        img_path = os.path.join(workdir, "images", name)
        if not os.path.exists(img_path):
            continue
        pred.set_image(np.asarray(Image.open(img_path).convert("RGB")))
        masks, scores, _ = pred.predict(np.asarray(spec["points"], np.float32),
                                        np.asarray(spec["labels"], np.int32))
        best = int(np.argmax(np.asarray(scores)))
        save_mask(masks[best], os.path.join(workdir, "masks", name + ".png"), invert=True)
        n += 1
        if progress:
            progress(i + 1, len(clicks))
    return n


def visualize_features(workdir: str, out_dir: Optional[str] = None) -> int:
    """Keypoint-overlay PNGs per image (the reference's feature preview,
    app/feature_extractor.py:440-459) -> ``previews/features/<img>.png``;
    returns the previews written."""
    from PIL import Image, ImageDraw

    proc_dir = out_dir or os.path.join(workdir, "previews", "features")
    os.makedirs(proc_dir, exist_ok=True)
    n = 0
    for name in _images(workdir):
        fpath = os.path.join(workdir, "features", name + ".features.npz")
        if not os.path.exists(fpath):
            continue
        with np.load(fpath) as z:
            xys, valid, fw, fh = z["xys"], z["valid"], float(z["width"]), float(z["height"])
        img = Image.open(os.path.join(workdir, "images", name)).convert("RGB")
        sx = img.width / fw
        sy = img.height / fh
        draw = ImageDraw.Draw(img)
        for (x, y), ok in zip(xys, valid):
            if not ok:
                continue
            x, y = x * sx, y * sy
            draw.ellipse([x - 2, y - 2, x + 2, y + 2], outline=(0, 255, 0))
        img.save(os.path.join(proc_dir, name + ".png"))
        n += 1
    return n


def visualize_matches(workdir: str, image_a: str, image_b: str,
                      out_path: Optional[str] = None) -> str:
    """Side-by-side match preview for one pair (the reference's,
    app/feature_matching.py:395-431), the first 500 stored matches; returns
    the PNG's path (``previews/matches_<a>_<b>.png`` by default)."""
    from PIL import Image, ImageDraw

    with open(os.path.join(workdir, "matches", "matches.json")) as f:
        raw = json.load(f)
    key = f"{image_a}|{image_b}"
    key_r = f"{image_b}|{image_a}"
    if key in raw:
        pairs = np.asarray(raw[key], np.int64)
    elif key_r in raw:
        pairs = np.asarray(raw[key_r], np.int64)[:, ::-1]
    else:
        raise KeyError(f"no matches stored for pair {image_a}, {image_b}")
    za, zb = (_load_features(workdir, [n])[n] for n in (image_a, image_b))
    ia = Image.open(os.path.join(workdir, "images", image_a)).convert("RGB")
    ib = Image.open(os.path.join(workdir, "images", image_b)).convert("RGB")
    h = max(ia.height, ib.height)
    canvas = Image.new("RGB", (ia.width + ib.width, h))
    canvas.paste(ia, (0, 0))
    canvas.paste(ib, (ia.width, 0))
    draw = ImageDraw.Draw(canvas)
    sa = (ia.width / float(za["width"]), ia.height / float(za["height"]))
    sb = (ib.width / float(zb["width"]), ib.height / float(zb["height"]))
    for fa, fb in pairs[:500]:
        xa, ya = za["xys"][fa] * sa
        xb, yb = zb["xys"][fb] * sb
        draw.line([xa, ya, ia.width + xb, yb], fill=(0, 200, 0), width=1)
    out_path = out_path or os.path.join(
        workdir, "previews", f"matches_{image_a}_{image_b}.png")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    canvas.save(out_path)
    return out_path


def estimate_depth(workdir: str, encoder: str = "vits", checkpoint: Optional[str] = None,
                   equirect: bool = False, camera_aware: bool = False,
                   progress: ProgressFn = None, device="cuda") -> int:
    """The Depth stage: ``depth/<img>_depth.npy`` and a colourised PNG for
    every image. ``equirect`` takes the multi-crop panorama path;
    ``camera_aware`` routes each image by its camera model (fisheye
    through the calibrated ERP resample, spherical through the multi-crop
    stitch). Without a converted checkpoint the maps are the normalised
    output of the seeded compact net. Returns the images processed; the
    network runs on CUDA unless ``device="cpu"``."""
    from PIL import Image

    from splat_one_tpu_torch.models.depth_tpu import DepthAnythingTPU, save_depth_outputs

    model = DepthAnythingTPU(encoder=encoder, checkpoint=checkpoint, device=device)
    out_dir = os.path.join(workdir, "depth")
    images = _images(workdir)
    for i, name in enumerate(images):
        bgr = np.asarray(Image.open(os.path.join(workdir, "images", name)).convert("RGB"))[
            ..., ::-1]
        cam = exif = None
        if camera_aware:
            exif = _load_exif(workdir, name)
            cam = _camera_for(workdir, exif)
        if cam is not None and cam["projection_type"] == "fisheye":
            H0, W0 = bgr.shape[:2]
            # the calibrated focal first, then EXIF's, then a wide default
            f_norm = cam.get("focal")
            if f_norm is None:
                f_norm = exif.get("focal_ratio", 0.5)
            f = f_norm * max(W0, H0)
            # the principal point from the camera model (OpenSfM's
            # normalised offsets from the image centre)
            cx = W0 / 2 + cam.get("c_x", 0.0) * max(W0, H0)
            cy = H0 / 2 + cam.get("c_y", 0.0) * max(W0, H0)
            K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)
            dist = np.array([cam.get("k1", 0.0), cam.get("k2", 0.0), cam.get("k3", 0.0),
                             cam.get("k4", 0.0)])
            depth = model.infer_fisheye(bgr, K, dist=dist)
        elif equirect or (cam is not None and cam["projection_type"] == "spherical"):
            depth = model.infer_equirectangular(bgr)
        else:
            depth = model.infer_image(bgr)
        save_depth_outputs(depth, out_dir, os.path.splitext(name)[0])
        if progress:
            progress(i + 1, len(images))
    return len(images)
