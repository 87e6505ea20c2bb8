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

The SfM stages take SIFT or HAHOG features and brute-force matching; the
other detectors (ORB, AKAZE, SURF) come with Slice F2, ALIKED and
LightGlue with Slice G, the live reconstruction viewer with Slice H.
Every stage runs on CUDA unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from splat_one_tpu_torch.utils.device import resolve as resolve_device

ProgressFn = Optional[Callable[[int, int], None]]

# options of the JAX package's stages that later slices port
LATER_FEATURES = {"ORB": "Slice F2", "AKAZE": "Slice F2", "SURF": "Slice F2",
                  "ALIKED": "Slice G (learned models)"}
LIVE_VIEWER_LATER = ("live_viewer_port > 0 is not ported yet: the live reconstruction viewer "
                     "(recon_viewer) comes with Slice H (the app shell)")


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
    hahog_peak_threshold: float = 1e-5,
    hahog_edge_threshold: float = 10.0,
    progress: ProgressFn = None,
    device="cuda",
) -> int:
    """images/ -> features/<img>.features.npz: keypoints in original
    pixels, descriptors, scores, validity (keypoints inside a
    ``masks/<img>.png`` region of value <= 127 dropped), bearings from the
    camera model and the angular size of one detection pixel. SIFT (the
    DoG detector, default) or HAHOG (Hessian detector + HOG descriptor;
    ``hahog_*`` are its thresholds)."""
    from PIL import Image

    from splat_one_tpu_torch.core import cameras as cam_mod
    from splat_one_tpu_torch.sfm import features as F

    ft = feature_type.upper()
    if ft in LATER_FEATURES:
        raise NotImplementedError(
            f"feature_type {feature_type!r} is not ported yet: it comes with "
            f"{LATER_FEATURES[ft]}")
    if ft not in ("SIFT", "HAHOG"):
        raise ValueError(f"feature_type {feature_type!r}: expected SIFT | HAHOG")
    dev = resolve_device(device)
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
        arr = torch.as_tensor(np.asarray(img).astype(np.float32) / 255.0, device=dev)
        if ft == "HAHOG":
            feats = F.extract_hahog(arr, max_keypoints=max_keypoints,
                                    peak_threshold=hahog_peak_threshold,
                                    edge_threshold=hahog_edge_threshold)
        else:
            feats = F.extract_features(arr, max_keypoints=max_keypoints,
                                       contrast_threshold=contrast_threshold)
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
    progress: ProgressFn = None,
    device="cuda",
) -> int:
    """features/ -> matches/matches.json (verified pairs). Brute-force
    mutual-NN + Lowe ratio, batched over pairs on the device ("flann" is
    the same exact path); verification by 8-point RANSAC with a
    resolution-aware threshold (1.6 detection pixels of angle, at most
    0.008 rad), its draws from a generator seeded 0."""
    from splat_one_tpu_torch.sfm import matching as M

    mt = matching_type.replace("-", "").replace("_", "").lower()
    if mt == "lightglue":
        raise NotImplementedError(
            "matching_type 'lightglue' is not ported yet: it comes with Slice G "
            "(learned models)")
    if mt not in ("bruteforce", "flann"):
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
    for the CLI's sake; ``live_viewer_port`` > 0 (the live reconstruction
    viewer) comes with Slice H."""
    from splat_one_tpu_torch.sfm import reconstruct as RC

    if live_viewer_port:
        raise NotImplementedError(LIVE_VIEWER_LATER)
    dev = resolve_device(device)
    images = _images(workdir)
    with open(os.path.join(workdir, "tracks.json")) as f:
        tracks = [{int(k): int(v) for k, v in tr.items()} for tr in json.load(f)]
    feats = _load_features(workdir, images)
    bearings = [feats[n]["bearings"].astype(np.float32) for n in images]
    ang_res = [float(feats[n]["angular_res"]) for n in images if "angular_res" in feats[n]]
    counts = {k: len(m) for k, m in _load_matches(workdir, images).items()}
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
    rec = RC.incremental_reconstruct(bearings, tracks, counts, cfg=cfg,
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
