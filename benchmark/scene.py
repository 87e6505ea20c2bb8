"""Seeded synthetic scenes with a capture's layout, made on the device:
the layout helpers that a model file's ``make_weights``
(``models/<model>.py``) draws its rows with, and the cameras.

A configuration file describes a scene as data: its regions (where the
gaussians lie, how large and how opaque they are) and the rows a grown
and pruned 3DGS run leaves dead. A model turns that description and a
seed into ``weights``, the stored parameters of a trained model in
``capacity`` rows, and ``alive``, the rows that hold its ``n_gaussians``
live gaussians. The buffer is laid out as the port's Trainer leaves it:

- rows ``[0, n + pruned)``: the live gaussians and ``pruned`` gaussians
  that densification pruned (their opacity fell under the prune level),
  interleaved, since growth fills the lowest free rows first; a pruned
  row keeps its last values, wherever in the scene it was;
- rows past them: the zero rows that doubling the capacity appended and
  no gaussian ever used (every field 0).

Every seed serves the same model, so that every run does the same work:
its gaussians come from one ``torch.Generator`` on the device with a seed
of the scene's own (``LAYOUT_SEED``), in a few large calls. The seed
orders the used rows in the buffer, as another run's densification
would. Region shapes: ``ball`` (uniform in a ball), ``disc`` (a thin
horizontal disc), ``shell`` (a thick spherical shell, cut to a band of
heights), ``box_surface`` (the six faces of a box, by area) and ``boxes``
(the surfaces of ``count`` boxes of given size range and place inside a
bound).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def np_rng(seed: int, salt: int) -> np.random.Generator:
    """A host generator for one purpose (``salt``) of one seed."""
    s = int(seed) % (1 << 64)
    return np.random.default_rng([salt, s & 0xFFFFFFFF, s >> 32])


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A device generator for one purpose (``salt``) of one seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (1 << 62))
    return g


def _uniform(g, n, dev, lo=0.0, hi=1.0):
    return torch.rand(n, generator=g, device=dev) * (hi - lo) + lo


# the seed of what every run shares: the model and the client's poses
LAYOUT_SEED = 0


def region_points(r: dict, n: int, g: torch.Generator, dev) -> torch.Tensor:
    c = torch.tensor(r.get("center", [0.0, 0.0, 0.0]), device=dev)
    shape = r["shape"]
    if shape == "ball":
        d = torch.randn((n, 3), generator=g, device=dev)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        rad = r["radius"] * _uniform(g, n, dev) ** (1.0 / r.get("radial_power", 3.0))
        return c + d * rad[:, None]
    if shape == "disc":
        rad = r["radius"] * torch.sqrt(_uniform(g, n, dev))
        ang = _uniform(g, n, dev, 0.0, 2 * math.pi)
        y = torch.randn(n, generator=g, device=dev) * r.get("thickness", 0.0)
        return c + torch.stack([rad * torch.cos(ang), y, rad * torch.sin(ang)], 1)
    if shape == "shell":
        # uniform directions with -y (up) between the band's limits
        up = _uniform(g, n, dev, *r.get("up_range", [-1.0, 1.0]))
        ang = _uniform(g, n, dev, 0.0, 2 * math.pi)
        h = torch.sqrt(torch.clamp(1 - up * up, min=0.0))
        d = torch.stack([h * torch.cos(ang), -up, h * torch.sin(ang)], 1)
        rad = _uniform(g, n, dev, r["r_min"], r["r_max"])
        return c + d * rad[:, None]
    if shape == "box_surface":
        lo = torch.tensor(r["min"], device=dev)
        hi = torch.tensor(r["max"], device=dev)
        return _box_surface(lo, hi, n, g, dev, r.get("thickness", 0.0))
    if shape == "boxes":
        k = r["count"]
        lo = torch.tensor(r["min"], device=dev)
        hi = torch.tensor(r["max"], device=dev)
        smin = torch.tensor(r["size_min"], device=dev)
        smax = torch.tensor(r["size_max"], device=dev)
        size = smin + torch.rand((k, 3), generator=g, device=dev) * (smax - smin)
        corner = lo + torch.rand((k, 3), generator=g, device=dev) * (hi - lo - size)
        which = torch.randint(0, k, (n,), generator=g, device=dev)
        unit = _box_surface(torch.zeros(3, device=dev), torch.ones(3, device=dev), n, g, dev,
                            0.0)
        return corner[which] + unit * size[which]
    raise ValueError(f"unknown region shape {shape!r}")


def _box_surface(lo, hi, n, g, dev, thickness):
    ext = hi - lo
    areas = torch.stack([ext[1] * ext[2], ext[0] * ext[2], ext[0] * ext[1]])
    axis = torch.multinomial(areas.repeat(2), n, replacement=True, generator=g)
    side = (axis >= 3).float()
    axis = axis % 3
    p = lo + torch.rand((n, 3), generator=g, device=dev) * ext
    face = torch.where(side.bool(), hi[axis], lo[axis])
    face = face + torch.randn(n, generator=g, device=dev) * thickness
    return p.scatter(1, axis[:, None], face[:, None])


def dead_rows(cfg: dict) -> int:
    """Pruned rows of the configuration: a share of the live ones, as many
    as fit below the capacity."""
    n, cap = int(cfg["n_gaussians"]), int(cfg["capacity"])
    return min(int(round(float(cfg["dead_rows"]["pruned_share"]) * n)), cap - n)


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """c2w with +z forward, y down (OpenCV), world up -y."""
    f = target - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.array([0.0, -1.0, 0.0]))
    r = r / (np.linalg.norm(r) + 1e-12)
    d = np.cross(f, r)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, :3] = np.stack([r, d, f], axis=1)
    c2w[:3, 3] = eye
    return c2w


def yaw_pose(eye: np.ndarray, yaw: float, pitch: float = 0.0) -> np.ndarray:
    """c2w looking along azimuth ``yaw`` (0 = +z) and ``pitch`` (up > 0)."""
    f = np.array([math.sin(yaw) * math.cos(pitch), -math.sin(pitch),
                  math.cos(yaw) * math.cos(pitch)])
    return look_at(eye, eye + f)


def intrinsics(cfg: dict) -> np.ndarray:
    f = float(cfg["focal_px"])
    return np.array([[f, 0, cfg["width"] / 2.0], [0, f, cfg["height"] / 2.0], [0, 0, 1]],
                    np.float32)


def orbit_pose(cam: dict, angle: float, dr: float = 0.0, dh: float = 0.0,
               dt=(0.0, 0.0, 0.0)) -> np.ndarray:
    """A pose on the capture's orbit (``radius``, ``height`` as y, looking at
    ``target``) at ``angle``, moved by the given offsets."""
    rad = cam["radius"] * (1.0 + dr)
    c = np.array(cam.get("center", [0.0, 0.0, 0.0]), np.float64)
    eye = c + np.array([rad * math.cos(angle), cam["height"] + dh, rad * math.sin(angle)])
    return look_at(eye, np.array(cam["target"], np.float64) + np.array(dt))
