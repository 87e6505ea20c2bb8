"""2D Gaussian Splatting's model (Huang et al., SIGGRAPH 2024,
arXiv:2403.17888) as gsplat's 2DGS trainer stores it
(``examples/simple_trainer_2dgs.py``): the same parameters as a 3DGS
model (means, wxyz quaternions, log scales, logit opacities, ``sh0`` /
``shN``), each row drawn as a flat disc (a surfel) whose tangent axes are
its rotation's first two columns, scaled by its first two scales; served
by the port's ``Renderer`` with ``primitive="2dgs"``
(``rasterization_2dgs``).

It gives what ``models/gaussians.py`` gives (``make_weights``,
``reference_rows`` and ``color`` are garden's, the rows laid out the same
way for the same seed; ``program``; ``OPS_PER_GAUSSIAN``,
``BYTES_PER_GAUSSIAN``) and the surfel's own work per (pixel, surfel)
pair, ``OPS_PER_PAIR``, and per surfel on screen, ``FIELDS``
(``benchmark/surfel_counts.py`` counts a view with them). The reference
renders it with ``benchmark/reference/surfel.py``.
"""

from __future__ import annotations

from benchmark.models import gaussians as G

make_weights = G.make_weights
reference_rows = G.reference_rows
color = G.color

# Per live surfel, one view: the quaternion normalised (12), its rotation's
# first two columns (23), scaled by s_u, s_v (6); the camera-frame centre
# (18) and tangent axes (2 x 15); T = K [...]'s rows u and v (2 x 9; w is
# the axes' and centre's z); mean2d from the unit disc's dual conic (the
# w-w entry 5, its reciprocal 1, two centres 2 x 6); r2 = 2 ln(255 o) and
# its clamp (5); the r2-disc's box (its w-w entry 2, reciprocal 1, two
# centres 2 x 7, two half widths 2 x 11); the filter's radius (3); the
# extents (2 x 6); the culling (13); the view direction (14), the 16 SH
# basis values (35) and the colour (96 + 6), as models/gaussians.py counts
# them.
OPS_PER_GAUSSIAN = (12 + 23 + 6 + 18 + 2 * 15 + 2 * 9 + 5 + 1 + 2 * 6 + 5
                    + 2 + 1 + 2 * 7 + 2 * 11 + 3 + 2 * 6 + 13 + 14 + 35 + 102)
# Read once per live surfel: mean 12, quaternion 16, the two scales it
# uses 8, opacity 4, 16 SH coefficients x 3 colours x 4 bytes.
BYTES_PER_GAUSSIAN = 12 + 16 + 8 + 4 + 192
# Per needed (pixel, surfel) pair: h_u and h_v (2 x 6), their cross
# product (9) and its c_z = 0 test (1), (a, b) = (c_x, c_y) / c_z (2),
# G3 = a^2 + b^2 (3), the offset from mean2d (2) and G2 = 2 |offset|^2
# (4), the min and the half (2), the exponential with its negation (2) and
# the opacity's product (1), the clamp and the kill tests (3), the weight
# (2), three colours and the depth accumulated (8), the transmittance
# update (2).
OPS_PER_PAIR = 2 * 6 + 9 + 1 + 2 + 3 + 2 + 4 + 2 + 2 + 1 + 3 + 2 + 8 + 2
# Per surfel on screen, the floats the projection writes and the forward
# reads once: mean2d 2, T 9, opacity 1, colour 3, depth 1 (a 64-byte row).
FIELDS = 16


def program(weights, alive, cfg: dict, mix: dict, dev):
    """The port's serving entry over the weights: ``Renderer`` drawing
    surfels."""
    from splat_one_tpu_torch.app.viewer import Renderer

    return Renderer(weights, alive, int(cfg["width"]), int(cfg["height"]),
                    sh_degree=int(cfg["sh_degree"]), camera_model=mix["camera_model"],
                    device=dev, primitive="2dgs")
