"""The 3D Gaussian Splatting model of the original paper: gaussians with
spherical harmonics of degree 3, served by the port's ``Renderer``.

- ``make_weights``: the stored parameters of a trained model (means, wxyz
  quaternions, log scales, logit opacities, SH bands ``sh0`` [cap, 1, 3]
  and ``shN`` [cap, 15, 3]) in ``capacity`` rows, laid out from the
  configuration's scene by ``benchmark.scene``, and ``alive``;
- ``program``: the port's entry that a kind drives;
- ``reference_rows`` and ``color``: what the reference renders, worked out
  again from the same weights;
- ``OPS_PER_GAUSSIAN`` and ``BYTES_PER_GAUSSIAN``: the work a view needs of
  each live gaussian, whatever implements it (``benchmark.counts``).

Every configuration without a ``model`` key is of this model.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import scene as S
from benchmark.reference import render as R

SH_C0 = 0.28209479177387814

# Per live gaussian, one view: the rotation from the quaternion (normalise
# 12, matrix 28), the 3D covariance (scale 9, M M^T 45), the camera-frame
# mean (18), the Jacobian (12), T = J R (30), T Sigma T^T (48), the conic,
# determinant and radius (22), the membership extents and culling (24),
# the view direction (14), the 16 SH basis values (35) and the colour
# (96 + 6).
OPS_PER_GAUSSIAN = 12 + 28 + 9 + 45 + 18 + 12 + 30 + 48 + 22 + 24 + 14 + 35 + 102
# Read once per live gaussian: mean 12, quaternion 16, scale 12, opacity 4,
# 16 SH coefficients x 3 colours x 4 bytes.
BYTES_PER_GAUSSIAN = 12 + 16 + 12 + 4 + 192


def make_weights(cfg: dict, seed: int, device) -> tuple:
    """(weights, alive) of the configuration's model, its used rows in the
    order ``seed`` gives them."""
    sc = cfg["scene"]
    n, cap = int(cfg["n_gaussians"]), int(cfg["capacity"])
    used = n + S.dead_rows(cfg)
    k_rest = (int(cfg["sh_degree"]) + 1) ** 2 - 1
    g = S.generator(S.LAYOUT_SEED, 1, device)
    shares = np.array([r["share"] for r in sc["regions"]], np.float64)
    sizes = np.floor(shares / shares.sum() * used).astype(np.int64)
    sizes[0] += used - sizes.sum()
    means, logs = [], []
    for r, m in zip(sc["regions"], sizes):
        means.append(S.region_points(r, int(m), g, device))
        mu, sd_g, sd_a = r["log_scale"]
        common = mu + sd_g * torch.randn((int(m), 1), generator=g, device=device)
        ls = common + sd_a * torch.randn((int(m), 3), generator=g, device=device)
        if r.get("flat", 0.0):
            ls[:, 0] -= r["flat"]
        logs.append(ls)
    op = sc["opacity"]
    high = torch.rand(used, generator=g, device=device) < op["high_share"]
    z = torch.randn(used, generator=g, device=device)
    logit = torch.where(high, op["high_logit"][0] + op["high_logit"][1] * z,
                        op["low_logit"][0] + op["low_logit"][1] * z)
    live = torch.zeros(used, dtype=torch.bool, device=device)
    live[torch.randperm(used, generator=g, device=device)[:n]] = True
    mu, sd = cfg["dead_rows"]["pruned_logit"]
    pruned = torch.clamp(mu + sd * torch.randn(used, generator=g, device=device),
                         max=cfg["dead_rows"]["prune_below_logit"])
    rgb = torch.rand((used, 3), generator=g, device=device) * 0.8 + 0.1
    rows = {"means": torch.cat(means), "quats": torch.randn((used, 4), generator=g, device=device),
            "scales": torch.cat(logs), "opacities": torch.where(live, logit, pruned),
            "sh0": ((rgb - 0.5) / SH_C0)[:, None, :],
            "shN": torch.randn((used, k_rest, 3), generator=g, device=device) * sc["sh_rest_std"]}
    # the seed's order: regions, and live and pruned rows, interleave in
    # the buffer, as a densified model's rows do
    order = torch.randperm(used, generator=S.generator(seed, 1, device), device=device)
    weights = {}
    for k, x in rows.items():
        weights[k] = torch.zeros((cap,) + tuple(x.shape[1:]), dtype=torch.float32, device=device)
        weights[k][:used] = x[order]
    alive = torch.zeros(cap, dtype=torch.bool, device=device)
    alive[:used] = live[order]
    return weights, alive


def program(weights, alive, cfg: dict, mix: dict, dev):
    """The port's serving entry over the weights: ``Renderer``."""
    from splat_one_tpu_torch.app.viewer import Renderer

    return Renderer(weights, alive, int(cfg["width"]), int(cfg["height"]),
                    sh_degree=int(cfg["sh_degree"]), camera_model=mix["camera_model"],
                    device=dev)


def reference_rows(weights, alive):
    """The live rows, activated, with their SH bands joined as ``sh``."""
    live = {k: v[alive] for k, v in weights.items()}
    return dict(R.activate(live), sh=torch.cat([live["sh0"], live["shN"]], dim=1))


def color(rows, front, dirs, dtype):
    """The colour of the rows ``front`` seen along ``dirs``: SH 3 plus 0.5,
    clamped at 0."""
    sh = rows["sh"].to(dtype)[front]
    return torch.clamp(torch.einsum("nk,nkc->nc", R.sh_basis3(dirs), sh[:, :16]) + 0.5,
                       min=0.0)
