"""COLMAP sparse-model reader (binary and text) -> training data: the
port's own copy of ``splat_one_tpu/data/colmap.py`` (host-side numpy).

Reads ``cameras.bin/txt``, ``images.bin/txt`` and ``points3D.bin/txt``
(the documented COLMAP formats), maps camera models to the port's camera
types and distortion (OPENCV_FISHEYE included), normalizes the world and
exposes the surface of ``data.opensfm.Parser``.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, NamedTuple

import numpy as np

from splat_one_tpu_torch.data import normalize as nrm

# COLMAP camera model ids -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
_NAME_TO_ID = {v[0]: k for k, v in _CAMERA_MODELS.items()}


class ColmapCamera(NamedTuple):
    model: str
    width: int
    height: int
    params: np.ndarray


def _read_bytes(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, "<Q")
        for _ in range(n):
            cid, model_id, w, h = _read_bytes(f, "<iiQQ")
            name, np_ = _CAMERA_MODELS[model_id]
            params = np.array(_read_bytes(f, f"<{np_}d"))
            cams[cid] = ColmapCamera(name, int(w), int(h), params)
    return cams


def read_images_bin(path: str):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, "<Q")
        for _ in range(n):
            iid = _read_bytes(f, "<i")[0]
            qvec = np.array(_read_bytes(f, "<4d"))
            tvec = np.array(_read_bytes(f, "<3d"))
            cid = _read_bytes(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read_bytes(f, "<Q")
            data = np.frombuffer(
                f.read(24 * npts), dtype=np.float64
            ).reshape(npts, 3)
            xys = data[:, :2].copy()
            # point3D ids are int64 interleaved as the 3rd column
            p3d = np.frombuffer(
                data[:, 2].tobytes(), dtype=np.int64
            )
            images[iid] = dict(
                qvec=qvec, tvec=tvec, camera_id=cid,
                name=name.decode("utf-8"), xys=xys, point3D_ids=p3d,
            )
    return images


def read_points3d_bin(path: str):
    with open(path, "rb") as f:
        (n,) = _read_bytes(f, "<Q")
        xyz = np.empty((n, 3), np.float64)
        rgb = np.empty((n, 3), np.uint8)
        err = np.empty((n,), np.float64)
        for i in range(n):
            _pid = _read_bytes(f, "<Q")[0]
            xyz[i] = _read_bytes(f, "<3d")
            rgb[i] = _read_bytes(f, "<3B")
            err[i] = _read_bytes(f, "<d")[0]
            (tl,) = _read_bytes(f, "<Q")
            f.read(8 * tl)  # track elements (image_id, point2D_idx)
    return xyz, rgb, err


def read_cameras_txt(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            cams[int(el[0])] = ColmapCamera(
                el[1], int(el[2]), int(el[3]),
                np.array([float(x) for x in el[4:]]),
            )
    return cams


def read_images_txt(path: str):
    images = {}
    with open(path) as f:
        lines = [
            line for line in f
            if not line.startswith("#") and line.strip()
        ]
    for i in range(0, len(lines), 2):
        el = lines[i].split()
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(
            [[float(pts[j]), float(pts[j + 1])] for j in range(0, len(pts), 3)]
        ) if pts else np.zeros((0, 2))
        p3d = np.array(
            [int(pts[j + 2]) for j in range(0, len(pts), 3)], np.int64
        ) if pts else np.zeros((0,), np.int64)
        images[int(el[0])] = dict(
            qvec=np.array([float(x) for x in el[1:5]]),
            tvec=np.array([float(x) for x in el[5:8]]),
            camera_id=int(el[8]), name=el[9], xys=xys, point3D_ids=p3d,
        )
    return images


def read_points3d_txt(path: str):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            el = line.split()
            xyz.append([float(x) for x in el[1:4]])
            rgb.append([int(x) for x in el[4:7]])
            err.append(float(el[7]))
    return (
        np.asarray(xyz, np.float64),
        np.asarray(rgb, np.uint8),
        np.asarray(err, np.float64),
    )


def _qvec2rotmat(q):
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class Parser:
    """Same surface as ``data.opensfm.Parser`` but from a COLMAP sparse
    model directory (``sparse/0`` with cameras/images/points3D)."""

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
        sparse = None
        for cand in ("sparse/0", "sparse", "."):
            p = os.path.join(data_dir, cand)
            if os.path.exists(os.path.join(p, "cameras.bin")) or os.path.exists(
                os.path.join(p, "cameras.txt")
            ):
                sparse = p
                break
        if sparse is None:
            raise FileNotFoundError(f"no COLMAP model under {data_dir}")
        if os.path.exists(os.path.join(sparse, "cameras.bin")):
            cams = read_cameras_bin(os.path.join(sparse, "cameras.bin"))
            images = read_images_bin(os.path.join(sparse, "images.bin"))
            xyz, rgb, err = read_points3d_bin(
                os.path.join(sparse, "points3D.bin")
            )
        else:
            cams = read_cameras_txt(os.path.join(sparse, "cameras.txt"))
            images = read_images_txt(os.path.join(sparse, "images.txt"))
            xyz, rgb, err = read_points3d_txt(
                os.path.join(sparse, "points3D.txt")
            )
        self._build(cams, images, xyz, rgb, err, normalize)

    def _build(self, cams, images, xyz, rgb, err, normalize):
        names, c2ws, Ks, models, dists = [], [], [], [], []
        widths, heights = [], []
        items = sorted(images.values(), key=lambda d: d["name"])
        for img in items:
            R = _qvec2rotmat(img["qvec"])
            w2c = np.eye(4)
            w2c[:3, :3] = R
            w2c[:3, 3] = img["tvec"]
            c2ws.append(np.linalg.inv(w2c))
            names.append(img["name"])
            cam = cams[img["camera_id"]]
            # camera model -> (K, camera_model, distortion) mapping
            # (reference colmap.py:85-105)
            p = cam.params
            if cam.model == "SIMPLE_PINHOLE":
                fx = fy = p[0]
                cx, cy = p[1], p[2]
                model, dist = "pinhole", np.zeros(4)
            elif cam.model == "PINHOLE":
                fx, fy, cx, cy = p[:4]
                model, dist = "pinhole", np.zeros(4)
            elif cam.model in ("SIMPLE_RADIAL", "RADIAL"):
                fx = fy = p[0]
                cx, cy = p[1], p[2]
                k = np.zeros(4)
                k[: len(p) - 3] = p[3:]
                model, dist = "pinhole", k
            elif cam.model == "OPENCV":
                fx, fy, cx, cy = p[:4]
                model, dist = "pinhole", p[4:8]
            elif cam.model == "OPENCV_FISHEYE":
                fx, fy, cx, cy = p[:4]
                model, dist = "fisheye", p[4:8]
            else:
                raise ValueError(f"unsupported COLMAP model {cam.model}")
            K = np.array(
                [[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64
            )
            Ks.append(K)
            models.append(model)
            dists.append(np.asarray(dist, np.float64))
            widths.append(cam.width)
            heights.append(cam.height)

        c2w = np.stack(c2ws)
        self.image_names = names
        self.camera_models = models
        self.widths, self.heights = widths, heights
        self.Ks = np.stack(Ks).astype(np.float32)
        self.dists = np.stack(
            [np.pad(d, (0, 4 - len(d))) for d in dists]
        ).astype(np.float32)
        self.errors = err.astype(np.float32)
        self.points_rgb = rgb

        self.transform = np.eye(4)
        if normalize and len(c2w):
            c2w, xyz, self.transform = nrm.normalize_scene(c2w, xyz)
        self.camtoworlds = c2w.astype(np.float32)
        self.points = xyz.astype(np.float32)
        if self.factor > 1:
            self.Ks[:, :2, :] /= self.factor

        centers = self.camtoworlds[:, :3, 3]
        d = np.linalg.norm(centers - centers.mean(axis=0), axis=-1)
        self.scene_scale = float(d.max()) * 1.1 if len(d) else 1.0
        self.image_paths = [
            os.path.join(self.data_dir, "images", n) for n in names
        ]
        self.image_name_to_idx = {n: i for i, n in enumerate(names)}
