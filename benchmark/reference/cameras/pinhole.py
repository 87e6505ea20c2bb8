"""The pinhole camera: perspective division, with 3DGS's Jacobian taken at
x/z and y/z clamped to 1.3 times the half field of view.

A camera model of the reference (``render.camera``) gives, on camera-frame
coordinates ``x, y, z`` (one tensor each, a row a gaussian) and the
intrinsics' ``fx, fy, cx, cy`` in pixels:

- ``WRAP``: whether the image wraps in u (a gaussian off its left or
  right side is then not culled, and its tiles wrap round);
- ``depth``: the depth the near and far test, the order and the expected
  depth use;
- ``screen``: the pixel position (u, v);
- ``jacobian``: d(u, v) / d(x, y, z), [N, 2, 3].
"""

import torch

WRAP = False


def depth(x, y, z):
    return z


def _inv_z(z):
    return 1.0 / torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)


def screen(x, y, z, fx, fy, cx, cy, width, height):
    iz = _inv_z(z)
    return fx * x * iz + cx, fy * y * iz + cy


def jacobian(x, y, z, fx, fy, width, height):
    zero = torch.zeros_like(x)
    zs = torch.clamp(z, min=1e-6)
    lx, ly = 1.3 * 0.5 * width / fx, 1.3 * 0.5 * height / fy
    xc = zs * torch.clamp(x / zs, -lx, lx)
    yc = zs * torch.clamp(y / zs, -ly, ly)
    iz = _inv_z(z)
    return torch.stack([fx * iz, zero, -fx * xc * iz * iz,
                        zero, fy * iz, -fy * yc * iz * iz], -1).reshape(-1, 2, 3)
