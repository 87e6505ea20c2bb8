"""The equirectangular camera: longitude across the width, latitude down
the height, the radial distance as depth; the image wraps in u. The
interface is ``pinhole.py``'s; the intrinsics are not used."""

import math

import torch

WRAP = True


def depth(x, y, z):
    return torch.sqrt(x * x + y * y + z * z + 1e-24)


def screen(x, y, z, fx, fy, cx, cy, width, height):
    r = torch.sqrt(x * x + y * y + z * z)
    lon = torch.atan2(x, z)
    lat = torch.asin(torch.clamp(-y / torch.clamp(r, min=1e-8), -1.0, 1.0))
    return (lon / (2.0 * math.pi) + 0.5) * width, (0.5 - lat / math.pi) * height


def jacobian(x, y, z, fx, fy, width, height):
    zero = torch.zeros_like(x)
    rxz2 = torch.clamp(x * x + z * z, min=1e-8)
    r2 = torch.clamp(x * x + y * y + z * z, min=1e-8)
    rxz = torch.sqrt(rxz2)
    cu, cv = width / (2.0 * math.pi), -height / math.pi
    return torch.stack([cu * z / rxz2, zero, -cu * x / rxz2,
                        cv * x * y / (r2 * rxz), -cv * rxz / r2, cv * z * y / (r2 * rxz)],
                       -1).reshape(-1, 2, 3)
