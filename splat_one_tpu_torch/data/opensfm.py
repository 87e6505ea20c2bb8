"""OpenSfM ``reconstruction.json`` -> training data: the port's own copy
of ``splat_one_tpu/data/opensfm.py`` (host-side numpy; PIL decodes the
in-RAM images).

Parses every reconstruction of the file and merges them in the UTM frame
of the first one's ``reference_lla``; angle-axis shot poses; perspective
(k1/k2), fisheye and spherical cameras; world normalization; and
``to_scene_data``, which builds the Trainer's ``SceneData`` with the
images in RAM or, with ``streaming=True``, behind a prefetching
``data.streaming.StreamingImages``. UTM is a transverse-Mercator series
(no pyproj); undistortion is a numpy inverse remap (no cv2).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from splat_one_tpu_torch.data import normalize as nrm


# ---------------------------------------------------------------------------
# small host-side geometry helpers
# ---------------------------------------------------------------------------


def angle_axis_to_rotmat(aa: np.ndarray) -> np.ndarray:
    """Rodrigues formula (OpenSfM shots store rotation as angle-axis)."""
    theta = np.linalg.norm(aa)
    if theta < 1e-12:
        return np.eye(3)
    k = aa / theta
    K = np.array(
        [[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]]
    )
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * K @ K


def latlon_to_utm(lat: float, lon: float, zone: int = None):
    """WGS84 lat/lon -> UTM easting/northing (transverse-Mercator series;
    replaces the reference's pyproj dependency, opensfm.py:408-411).
    Accuracy ~mm within a zone — ample for merging reconstructions.

    Pass an explicit ``zone`` when converting a SET of points (e.g. every
    image's GPS fix): per-point zone selection makes coordinates across a
    zone boundary discontinuous by hundreds of km."""
    a = 6378137.0
    f = 1 / 298.257223563
    k0 = 0.9996
    e2 = f * (2 - f)
    ep2 = e2 / (1 - e2)
    if zone is None:
        zone = int(lon // 6) + 31
    lon0 = np.radians((zone - 1) * 6 - 180 + 3)
    phi = np.radians(lat)
    lam = np.radians(lon) - lon0

    N = a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
    T = np.tan(phi) ** 2
    C = ep2 * np.cos(phi) ** 2
    A = np.cos(phi) * lam

    M = a * (
        (1 - e2 / 4 - 3 * e2**2 / 64 - 5 * e2**3 / 256) * phi
        - (3 * e2 / 8 + 3 * e2**2 / 32 + 45 * e2**3 / 1024) * np.sin(2 * phi)
        + (15 * e2**2 / 256 + 45 * e2**3 / 1024) * np.sin(4 * phi)
        - (35 * e2**3 / 3072) * np.sin(6 * phi)
    )
    easting = (
        k0
        * N
        * (
            A
            + (1 - T + C) * A**3 / 6
            + (5 - 18 * T + T**2 + 72 * C - 58 * ep2) * A**5 / 120
        )
        + 500000.0
    )
    northing = k0 * (
        M
        + N
        * np.tan(phi)
        * (
            A**2 / 2
            + (5 - T + 9 * C + 4 * C**2) * A**4 / 24
            + (61 - 58 * T + T**2 + 600 * C - 330 * ep2) * A**6 / 720
        )
    )
    if lat < 0:
        northing += 10000000.0
    return easting, northing, zone


def undistort_maps(
    K: np.ndarray, dist: np.ndarray, width: int, height: int,
    camera_type: str = "perspective",
):
    """Inverse remap coordinates (xs, ys) + validity mask for
    undistortion — the reference's cv2.initUndistortRectifyMap /
    fisheye.initUndistortRectifyMap analog with an explicit mask
    (opensfm.py:246-298).

    ``perspective``: Brown-Conrady k1/k2 (+ tangential p1/p2) (forward distortion applied to the
    ideal coords — exact inverse remap). ``fisheye``: equidistant model
    with theta-polynomial k1..k4 (OpenCV fisheye convention): the
    undistorted ideal ray at radius r maps to distorted radius
    theta_d = theta (1 + k1 th^2 + k2 th^4 + k3 th^6 + k4 th^8),
    theta = atan(r). The mask marks pixels whose source lands outside the
    distorted image (the reference masks these after remap)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    x = (u - cx) / fx
    y = (v - cy) / fy
    if camera_type == "fisheye":
        k = np.zeros(4)
        k[: min(len(dist), 4)] = np.asarray(dist[:4], np.float64)
        r = np.sqrt(x * x + y * y)
        theta = np.arctan(r)
        th2 = theta * theta
        theta_d = theta * (
            1.0 + th2 * (k[0] + th2 * (k[1] + th2 * (k[2] + th2 * k[3])))
        )
        scale = np.where(r > 1e-9, theta_d / np.maximum(r, 1e-9), 1.0)
        xs = x * scale * fx + cx
        ys = y * scale * fy + cy
    else:
        k1 = float(dist[0]) if len(dist) > 0 else 0.0
        k2 = float(dist[1]) if len(dist) > 1 else 0.0
        p1 = float(dist[2]) if len(dist) > 2 else 0.0
        p2 = float(dist[3]) if len(dist) > 3 else 0.0
        r2 = x * x + y * y
        d = 1.0 + r2 * (k1 + k2 * r2)
        # Brown-Conrady incl. tangential p1/p2 (the COLMAP OPENCV model
        # maps dist = [k1, k2, p1, p2]; radial-only dropped them)
        xd = x * d + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        yd = y * d + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xs = xd * fx + cx
        ys = yd * fy + cy
    valid = (xs >= 0) & (xs < width - 1) & (ys >= 0) & (ys < height - 1)
    return xs, ys, valid


def remap_bilinear(img: np.ndarray, xs: np.ndarray, ys: np.ndarray,
                   valid: np.ndarray) -> np.ndarray:
    """Bilinear inverse remap; invalid pixels -> 0."""
    H, W = img.shape[:2]
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, W - 2)
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, H - 2)
    wx = np.clip(xs - x0, 0, 1)[..., None]
    wy = np.clip(ys - y0, 0, 1)[..., None]
    im = img.astype(np.float32)
    out = (
        im[y0, x0] * (1 - wx) * (1 - wy)
        + im[y0, x0 + 1] * wx * (1 - wy)
        + im[y0 + 1, x0] * (1 - wx) * wy
        + im[y0 + 1, x0 + 1] * wx * wy
    )
    out[~valid] = 0
    return out.astype(img.dtype)


def undistort_image(
    img: np.ndarray, K: np.ndarray, dist: np.ndarray,
    camera_type: str = "perspective",
) -> np.ndarray:
    """Pure-numpy undistortion (bilinear inverse remap) — replaces the
    reference's cv2.initUndistortRectifyMap path (opensfm.py:246-298).
    Supports Brown radial (k1/k2) and fisheye theta-polynomial models."""
    if camera_type != "fisheye" and np.all(np.abs(dist[:2]) < 1e-12):
        return img
    H, W = img.shape[:2]
    xs, ys, valid = undistort_maps(K, dist, W, H, camera_type)
    return remap_bilinear(img, xs, ys, valid)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------


class Parser:
    """Parses reconstruction.json into camera/pose/point arrays.

    Attributes: ``camtoworlds [M,4,4]``, ``Ks [M,3,3]``, ``image_names``,
    ``image_paths``, ``camera_models`` (per image: 'pinhole'|'spherical'),
    ``dists [M,4]`` (k1..k4; radial or fisheye theta-poly), ``points
    [P,3]``, ``points_rgb [P,3] uint8``,
    ``scene_scale``, ``transform [4,4]``.
    """

    def __init__(
        self,
        data_dir: str,
        factor: int = 1,
        normalize: bool = True,
        test_every: int = 8,
    ):
        self.data_dir = data_dir
        self.factor = factor
        self.test_every = test_every
        recon_path = os.path.join(data_dir, "reconstruction.json")
        with open(recon_path) as f:
            reconstructions = json.load(f)
        if isinstance(reconstructions, dict):
            reconstructions = [reconstructions]
        self._parse(reconstructions, normalize)

    def _parse(self, reconstructions: List[Dict], normalize: bool):
        # UTM reference of the first reconstruction anchors the world
        # (reference opensfm.py:404-417, 444-465).
        ref0 = reconstructions[0].get("reference_lla")
        if ref0 is not None:
            e0, n0, zone0 = latlon_to_utm(
                ref0["latitude"], ref0["longitude"]
            )
            alt0 = ref0["altitude"]
        c2ws, Ks, names, models, dists, widths, heights = (
            [], [], [], [], [], [], [],
        )
        pts, rgbs = [], []
        for rec in reconstructions:
            ref = rec.get("reference_lla")
            if ref is not None and ref0 is not None:
                e, n, _ = latlon_to_utm(
                    ref["latitude"], ref["longitude"], zone0
                )
                diff = np.array(
                    [e - e0, n - n0, ref["altitude"] - alt0], np.float64
                )
            else:
                diff = np.zeros(3)
            cams = {}
            for cname, c in rec["cameras"].items():
                ptype = c.get("projection_type", "perspective")
                W, H = c["width"], c["height"]
                if ptype in ("spherical", "equirectangular"):
                    cams[cname] = dict(
                        model="spherical", K=np.eye(3), dist=np.zeros(2),
                        width=W, height=H,
                    )
                elif ptype in ("fisheye", "fisheye_opencv", "fisheye62"):
                    focal = c.get("focal", c.get("focal_x", 0.85))
                    f = focal * max(W, H)
                    K = np.array(
                        [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                        np.float64,
                    )
                    cams[cname] = dict(
                        model="fisheye", K=K,
                        dist=np.array([
                            c.get("k1", 0.0), c.get("k2", 0.0),
                            c.get("k3", 0.0), c.get("k4", 0.0),
                        ]),
                        width=W, height=H,
                    )
                else:  # perspective / brown -> pinhole + k1,k2
                    focal = c.get("focal", c.get("focal_x", 0.85))
                    f = focal * max(W, H)
                    K = np.array(
                        [[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]],
                        np.float64,
                    )
                    cams[cname] = dict(
                        model="pinhole", K=K,
                        dist=np.array(
                            [c.get("k1", 0.0), c.get("k2", 0.0)]
                        ),
                        width=W, height=H,
                    )
            for shot_name, shot in rec["shots"].items():
                R = angle_axis_to_rotmat(np.asarray(shot["rotation"]))
                t = np.asarray(shot["translation"], np.float64)
                w2c = np.eye(4)
                w2c[:3, :3] = R
                w2c[:3, 3] = t
                c2w = np.linalg.inv(w2c)
                # shift this reconstruction into the shared UTM frame: the
                # world offset moves camera centers and points alike
                c2w[:3, 3] += diff
                cam = cams[shot["camera"]]
                c2ws.append(c2w)
                Ks.append(cam["K"])
                names.append(shot_name)
                models.append(cam["model"])
                d = np.zeros(4)
                d[: len(cam["dist"])] = cam["dist"]
                dists.append(d)
                widths.append(cam["width"])
                heights.append(cam["height"])
            for p in rec.get("points", {}).values():
                pts.append(np.asarray(p["coordinates"]) + diff)
                rgbs.append(np.asarray(p["color"]))

        order = np.argsort(names)
        self.image_names = [names[i] for i in order]
        self.camera_models = [models[i] for i in order]
        c2w = np.stack([c2ws[i] for i in order]).astype(np.float64)
        self.Ks = np.stack([Ks[i] for i in order]).astype(np.float32)
        self.dists = np.stack([dists[i] for i in order]).astype(np.float32)
        self.widths = [widths[i] for i in order]
        self.heights = [heights[i] for i in order]
        points = (
            np.stack(pts).astype(np.float64)
            if pts
            else np.zeros((0, 3))
        )
        self.points_rgb = (
            np.stack(rgbs).astype(np.uint8)
            if rgbs
            else np.zeros((0, 3), np.uint8)
        )

        self.transform = np.eye(4)
        if normalize and len(c2w) > 0:
            c2w, points, self.transform = nrm.normalize_scene(c2w, points)
        self.camtoworlds = c2w.astype(np.float32)
        self.points = points.astype(np.float32)

        if self.factor > 1:
            self.Ks = self.Ks.copy()
            self.Ks[:, :2, :] /= self.factor

        # scene scale: max camera distance from center (gsplat convention,
        # reference gsplat_trainer.py:330-333 scene_scale * 1.1 * global)
        if len(c2w):
            centers = self.camtoworlds[:, :3, 3]
            dists_c = np.linalg.norm(
                centers - centers.mean(axis=0), axis=-1
            )
            self.scene_scale = float(dists_c.max()) * 1.1
        else:
            self.scene_scale = 1.0

        self.image_paths = [
            os.path.join(self.data_dir, "images", n)
            for n in self.image_names
        ]
        self.image_name_to_idx = {
            n: i for i, n in enumerate(self.image_names)
        }


def load_image(path: str, factor: int = 1) -> np.ndarray:
    from PIL import Image as PILImage

    img = PILImage.open(path).convert("RGB")
    if factor > 1:
        img = img.resize(
            (img.width // factor, img.height // factor), PILImage.BILINEAR
        )
    return np.asarray(img)


def to_scene_data(
    parser: Parser,
    test_every: int = 8,
    max_images: Optional[int] = None,
    streaming: bool = False,
    cache_images: int = 64,
):
    """Build a trainer SceneData; ``streaming=True`` keeps images on disk
    behind a prefetching ``data.streaming.StreamingImages`` (native C++
    decode pool when available) instead of one in-RAM ndarray — the
    reference's DataLoader-worker role (gsplat_trainer.py:562-572) for
    scenes whose image set exceeds host memory.

    All images must share one resolution (the reference datasets do after
    its resize step); heterogeneous sizes raise."""
    from splat_one_tpu_torch.train.trainer import SceneData

    n = len(parser.image_paths)
    if max_images:
        n = min(n, max_images)
    if streaming:
        from PIL import Image as PILImage

        from splat_one_tpu_torch.data.streaming import StreamingImages

        with PILImage.open(parser.image_paths[0]) as im0:
            w0, h0 = im0.width, im0.height
        w0, h0 = w0 // parser.factor, h0 // parser.factor
        images = StreamingImages(
            parser.image_paths[:n], w0, h0,
            Ks=parser.Ks[:n], dists=parser.dists[:n],
            camera_types=[
                "fisheye" if m == "fisheye" else "perspective"
                for m in parser.camera_models[:n]
            ],
            cache_images=cache_images,
        )
    else:
        imgs = []
        for i in range(n):
            img = load_image(parser.image_paths[i], parser.factor)
            ctype = (
                "fisheye"
                if parser.camera_models[i] == "fisheye" else "perspective"
            )
            if ctype == "fisheye" or np.any(
                np.abs(parser.dists[i]) > 1e-12
            ):
                img = undistort_image(
                    img, parser.Ks[i], parser.dists[i], camera_type=ctype
                )
            imgs.append(img)
        shapes = {im.shape for im in imgs}
        if len(shapes) > 1:
            raise ValueError(f"heterogeneous image sizes: {shapes}")
        images = np.stack(imgs)
    camera_model = (
        "spherical"
        if parser.camera_models and parser.camera_models[0] == "spherical"
        else "pinhole"
    )
    return SceneData(
        camtoworlds=parser.camtoworlds[:n],
        Ks=parser.Ks[:n],
        images=images,
        points=parser.points,
        points_rgb=parser.points_rgb.astype(np.float32) / 255.0,
        scene_scale=parser.scene_scale,
        camera_model=camera_model,
        image_names=parser.image_names[:n],
    )
