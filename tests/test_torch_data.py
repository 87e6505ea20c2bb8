"""Port parity: the data layer (``data/normalize``, ``data/opensfm``,
``data/colmap``, ``data/traj``, ``data/depth_supervision``) against the JAX
package on the same inputs.

The port's modules are numpy copies, so every output is held to exact
equality. The workdirs are those of tests/test_data.py, rebuilt here: an
OpenSfM reconstruction with a perspective (k1/k2) and a spherical camera
and a ``reference_lla`` (also merged with a second reconstruction ~111 m
north), and a COLMAP model with a PINHOLE and an OPENCV_FISHEYE camera in
text and binary form.
"""

import json
import struct

import numpy as np
import pytest
from PIL import Image

from splat_one_tpu.data import colmap as jcolmap
from splat_one_tpu.data import depth_supervision as jds
from splat_one_tpu.data import normalize as jnrm
from splat_one_tpu.data import opensfm as jopensfm
from splat_one_tpu.data import traj as jtraj
from splat_one_tpu_torch.data import colmap, depth_supervision, normalize, opensfm, traj
from splat_one_tpu_torch.data.synthetic import ring_cameras

PARSER_FIELDS = ("camtoworlds", "Ks", "dists", "points", "points_rgb", "transform",
                 "scene_scale", "image_names", "image_paths", "camera_models", "widths",
                 "heights", "image_name_to_idx")


def _same(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(a, b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    else:
        assert a == b


def _same_parser(p, q, fields=PARSER_FIELDS):
    for f in fields:
        _same(getattr(p, f), getattr(q, f))


def test_normalize_matches_jax():
    rng = np.random.default_rng(0)
    c2ws, _ = ring_cameras(8, 3.0, -0.5, 60.0, 64, 64)
    c2ws = c2ws.astype(np.float64)
    pts = rng.normal(size=(100, 3)) * np.array([5.0, 1.0, 0.2])
    for method in ("focus", "poses"):
        for strict in (False, True):
            _same(normalize.similarity_from_cameras(c2ws, strict, method),
                  jnrm.similarity_from_cameras(c2ws, strict, method))
    _same(normalize.align_principal_axes(pts), jnrm.align_principal_axes(pts))
    a, b = np.array([0.0, 0, 1.0]), np.array([0.0, 0, -1.0])
    _same(normalize._rotation_aligning(a, b), jnrm._rotation_aligning(a, b))
    _same(normalize.normalize_scene(c2ws.copy(), pts.copy()),
          jnrm.normalize_scene(c2ws.copy(), pts.copy()))
    _same(normalize.normalize_scene(c2ws.copy(), np.zeros((0, 3))),
          jnrm.normalize_scene(c2ws.copy(), np.zeros((0, 3))))


def _opensfm_recon(rng, prefix=""):
    recon = {
        "cameras": {
            "cam1": {"projection_type": "perspective", "width": 64, "height": 48,
                     "focal": 0.9, "k1": 0.01, "k2": -0.002},
            "pano": {"projection_type": "spherical", "width": 128, "height": 64},
            "fish": {"projection_type": "fisheye", "width": 64, "height": 48,
                     "focal": 0.5, "k1": 0.02, "k2": 0.001},
        },
        "shots": {}, "points": {},
        "reference_lla": {"latitude": 35.0, "longitude": 139.0, "altitude": 10.0},
    }
    for i in range(6):
        recon["shots"][f"{prefix}img_{i:03d}.jpg"] = {
            "rotation": (rng.normal(size=3) * 0.3).tolist(),
            "translation": rng.normal(size=3).tolist(),
            "camera": ("cam1", "pano", "fish")[i % 3]}
    for i in range(50):
        recon["points"][str(i)] = {"coordinates": rng.normal(size=3).tolist(),
                                   "color": rng.integers(0, 255, 3).tolist()}
    return recon


@pytest.fixture
def opensfm_workdir(tmp_path):
    with open(tmp_path / "reconstruction.json", "w") as f:
        json.dump([_opensfm_recon(np.random.default_rng(0))], f)
    return tmp_path


def test_opensfm_parser_matches_jax(opensfm_workdir, tmp_path):
    wd = str(opensfm_workdir)
    for kw in (dict(normalize=True), dict(normalize=False), dict(factor=2)):
        _same_parser(opensfm.Parser(wd, **kw), jopensfm.Parser(wd, **kw))
    # two reconstructions merged in the UTM frame of the first
    rec2 = _opensfm_recon(np.random.default_rng(1), prefix="b_")
    rec2["reference_lla"]["latitude"] += 0.001
    with open(opensfm_workdir / "reconstruction.json") as f:
        recs = json.load(f)
    with open(opensfm_workdir / "reconstruction.json", "w") as f:
        json.dump(recs + [rec2], f)
    p = opensfm.Parser(wd, normalize=False)
    _same_parser(p, jopensfm.Parser(wd, normalize=False))
    shift = np.linalg.norm(p.camtoworlds[p.image_name_to_idx["b_img_000.jpg"]][:3, 3]
                           - p.camtoworlds[p.image_name_to_idx["img_000.jpg"]][:3, 3])
    assert 50 < shift < 200, shift


def test_geometry_helpers_match_jax():
    for lat, lon, zone in ((35.0, 139.0, None), (35.001, 139.0, None), (-33.9, 151.2, None),
                           (48.0, 11.99, 33), (0.0, 0.0, None)):
        _same(opensfm.latlon_to_utm(lat, lon, zone), jopensfm.latlon_to_utm(lat, lon, zone))
    rng = np.random.default_rng(0)
    for aa in (rng.normal(size=3), np.zeros(3)):
        _same(opensfm.angle_axis_to_rotmat(aa), jopensfm.angle_axis_to_rotmat(aa))
    img = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    img8 = (img * 255).astype(np.uint8)
    K = np.array([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]])
    for ctype, dist in (("perspective", np.array([0.05, -0.01, 0.001, 0.002])),
                        ("perspective", np.zeros(4)),
                        ("fisheye", np.array([0.02, 0.001, 0.0, 0.0]))):
        _same(opensfm.undistort_maps(K, dist, 64, 48, ctype),
              jopensfm.undistort_maps(K, dist, 64, 48, ctype))
        for im in (img, img8):
            _same(opensfm.undistort_image(im, K, dist, ctype),
                  jopensfm.undistort_image(im, K, dist, ctype))


def test_to_scene_data_matches_jax(opensfm_workdir):
    """In-RAM images (PNG, one camera with k1/k2 undistorted on load) and
    every other SceneData field equal to the JAX package's."""
    rng = np.random.default_rng(3)
    recon = _opensfm_recon(rng)
    recon["cameras"] = {"cam1": recon["cameras"]["cam1"]}
    recon["shots"] = {k.replace(".jpg", ".png"): dict(v, camera="cam1")
                      for k, v in recon["shots"].items()}
    with open(opensfm_workdir / "reconstruction.json", "w") as f:
        json.dump(recon, f)
    (opensfm_workdir / "images").mkdir()
    for name in recon["shots"]:
        Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
            opensfm_workdir / "images" / name)
    wd = str(opensfm_workdir)
    s = opensfm.to_scene_data(opensfm.Parser(wd), max_images=5)
    sj = jopensfm.to_scene_data(jopensfm.Parser(wd), max_images=5)
    assert type(s).__module__.startswith("splat_one_tpu_torch")
    _same(tuple(s), tuple(sj))
    assert s.images.shape == (5, 48, 64, 3) and s.images.dtype == np.uint8


@pytest.fixture
def colmap_dir(tmp_path):
    d = tmp_path / "sparse" / "0"
    d.mkdir(parents=True)
    with open(d / "cameras.txt", "w") as f:
        f.write("# comment\n")
        f.write("1 PINHOLE 64 48 60.0 60.0 32.0 24.0\n")
        f.write("2 OPENCV_FISHEYE 64 48 30 30 32 24 0.01 0.0 0.0 0.0\n")
        f.write("3 OPENCV 64 48 50 52 31 23 0.01 -0.002 0.001 0.0005\n")
    rng = np.random.default_rng(0)
    with open(d / "images.txt", "w") as f:
        f.write("# comment\n")
        for i in range(6):
            q = rng.normal(size=4)
            q /= np.linalg.norm(q)
            t = rng.normal(size=3)
            f.write(f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} "
                    f"{t[0]} {t[1]} {t[2]} {1 + i % 3} im_{i}.png\n")
            f.write("10.0 12.0 -1 20.5 7.25 3\n")
    with open(d / "points3D.txt", "w") as f:
        f.write("# comment\n")
        for i in range(20):
            x, y, z = rng.normal(size=3)
            f.write(f"{i} {x} {y} {z} 100 150 200 0.5 1 0\n")
    return tmp_path


def _write_colmap_bin(src_dir, d):
    """The text model of ``src_dir`` written in COLMAP's binary format."""
    d.mkdir(parents=True)
    cams = jcolmap.read_cameras_txt(str(src_dir / "cameras.txt"))
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, c in cams.items():
            f.write(struct.pack("<iiQQ", cid, jcolmap._NAME_TO_ID[c.model], c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))
    imgs = jcolmap.read_images_txt(str(src_dir / "images.txt"))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for iid, im in imgs.items():
            f.write(struct.pack("<i", iid))
            f.write(struct.pack("<4d", *im["qvec"]))
            f.write(struct.pack("<3d", *im["tvec"]))
            f.write(struct.pack("<i", im["camera_id"]))
            f.write(im["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", len(im["point3D_ids"])))
            for (x, y), pid in zip(im["xys"], im["point3D_ids"]):
                f.write(struct.pack("<ddq", x, y, pid))
    xyz, rgb, err = jcolmap.read_points3d_txt(str(src_dir / "points3D.txt"))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *xyz[i]))
            f.write(struct.pack("<3B", *rgb[i]))
            f.write(struct.pack("<d", err[i]))
            f.write(struct.pack("<Q", 1))
            f.write(struct.pack("<ii", 1, 0))


def test_colmap_text_and_binary_match_jax(colmap_dir, tmp_path):
    txt = colmap_dir / "sparse" / "0"
    for reader in ("read_cameras_txt", "read_images_txt", "read_points3d_txt"):
        name = {"read_cameras_txt": "cameras.txt", "read_images_txt": "images.txt",
                "read_points3d_txt": "points3D.txt"}[reader]
        _same(getattr(colmap, reader)(str(txt / name)), getattr(jcolmap, reader)(str(txt / name)))
    fields = PARSER_FIELDS + ("errors",)
    for kw in (dict(normalize=True), dict(normalize=False), dict(factor=2)):
        _same_parser(colmap.Parser(str(colmap_dir), **kw), jcolmap.Parser(str(colmap_dir), **kw),
                     fields)
    bdir = tmp_path / "bin"
    _write_colmap_bin(txt, bdir / "sparse" / "0")
    b = bdir / "sparse" / "0"
    _same(colmap.read_cameras_bin(str(b / "cameras.bin")),
          jcolmap.read_cameras_bin(str(b / "cameras.bin")))
    _same(colmap.read_images_bin(str(b / "images.bin")),
          jcolmap.read_images_bin(str(b / "images.bin")))
    _same(colmap.read_points3d_bin(str(b / "points3D.bin")),
          jcolmap.read_points3d_bin(str(b / "points3D.bin")))
    p = colmap.Parser(str(bdir), normalize=True)
    _same_parser(p, jcolmap.Parser(str(bdir), normalize=True), fields)
    # the binary model parses to the text model's cameras and points
    pt = colmap.Parser(str(colmap_dir), normalize=True)
    np.testing.assert_allclose(p.camtoworlds, pt.camtoworlds, atol=1e-6)
    assert set(p.camera_models) == {"pinhole", "fisheye"}
    with pytest.raises(FileNotFoundError):
        colmap.Parser(str(tmp_path / "nothing"))


def test_traj_matches_jax():
    c2ws, _ = ring_cameras(12, 3.0, -0.8, 60.0, 64, 48)
    c2ws = c2ws.astype(np.float32)
    for fn, kw in (("generate_interpolated_path", dict(n_interp=5)),
                   ("generate_ellipse_path_z", dict(n_frames=17, variation=0.1, phase=0.3)),
                   ("generate_ellipse_path_y", dict(n_frames=17, height_offset=0.2)),
                   ("generate_spiral_path", dict(n_frames=19, n_rots=3))):
        out = getattr(traj, fn)(c2ws, **kw)
        _same(out, getattr(jtraj, fn)(c2ws, **kw))
        assert np.isfinite(out).all() and out.shape[1:] == (4, 4)
    _same(traj.generate_interpolated_path(c2ws[:1]), jtraj.generate_interpolated_path(c2ws[:1]))


def test_depth_supervision_matches_jax():
    rng = np.random.default_rng(0)
    c2ws, Ks = ring_cameras(4, 3.0, -0.8, 60.0, 40, 30)
    pts = rng.normal(size=(300, 3)) * 0.7
    for model in ("pinhole", "spherical"):
        for i in range(2):
            d = depth_supervision.sparse_depth_map(pts, c2ws[i], Ks[i], 40, 30, model)
            _same(d, jds.sparse_depth_map(pts, c2ws[i], Ks[i], 40, 30, model))
            assert (d > 0).sum() > 20
    _same(depth_supervision.sparse_depth_map(np.zeros((0, 3)), c2ws[0], Ks[0], 40, 30),
          jds.sparse_depth_map(np.zeros((0, 3)), c2ws[0], Ks[0], 40, 30))
    tracks = [{0: 1, 2: 5}, {1: 0}, {0: 3, 1: 2, 3: 9}, {7: 1}]
    points = {0: pts[0], 2: pts[2], 3: pts[3]}
    _same(depth_supervision.depth_maps_from_tracks(tracks, points, c2ws, Ks, 40, 30),
          jds.depth_maps_from_tracks(tracks, points, c2ws, Ks, 40, 30))
