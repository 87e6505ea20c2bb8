"""3D Gaussian Splatting with gsplat's appearance model in place of SH:
per gaussian ``features`` [32] and colour logits ``colors`` [3], per
training image an embedding [16], and one MLP colour head (gsplat's
``AppearanceOptModule``, ``examples/utils.py``; ``simple_trainer.py
--app_opt``). For a camera with embedding ``e`` and the unit direction
``d`` from its centre to a gaussian's mean:

    h0  = [e, features, Y_0..15(d)]         64 inputs (SH basis, degree 3)
    h1  = relu(h0 W0 + b0)                  64 -> 64
    h2  = relu(h1 W1 + b1)                  64 -> 64  (mlp_depth 2: hidden layers)
    rgb = sigmoid(colors + h2 W2 + b2)      64 -> 3

served by the port's ``Renderer`` with the embedding of image 0
(``SERVED_IMAGE``). The file gives what ``models/gaussians.py`` gives
(``make_weights``, ``program``, ``reference_rows``, ``color``, the
counts) and the head's own work a row (``APP_OPS_PER_ROW``,
``APP_BYTES_PER_ROW``): a view needs the projection of every live
gaussian (``OPS_PER_GAUSSIAN``, ``BYTES_PER_GAUSSIAN``) and the head's
colour of the gaussians on screen alone, which is what
``metrics/mfu.app.py`` and ``metrics/appearance_roofline.py`` count.

``color`` is the reference's head: the equations above in plain torch,
in the reference's dtype, with nothing of the port.
"""

from __future__ import annotations

import math

import torch

from benchmark import scene as S
from benchmark.models import gaussians as G
from benchmark.reference import render as R

# the published widths the counts below are of (gsplat's defaults)
FEATURE_DIM = 32
EMBED_DIM = 16
BASIS = 16  # SH of degree 3
MLP_WIDTH = 64
HIDDEN_LAYERS = 2
# the training image whose embedding the viewer serves (as the port's
# Trainer.render_view; gsplat's own viewer serves a zero embedding)
SERVED_IMAGE = 0

# Per live gaussian, the projection with the head's colour given:
# models/gaussians.py's count less its view direction (14), SH basis (35)
# and colour (102).
OPS_PER_GAUSSIAN = G.OPS_PER_GAUSSIAN - 14 - 35 - 102
# Read once per live gaussian by the projection: mean 12, quaternion 16,
# scale 12, opacity 4, the head's colour 12.
BYTES_PER_GAUSSIAN = 12 + 16 + 12 + 4 + 12
# The head, per row: the direction from the camera centre, normalised (14);
# the 16 SH basis values (35, as models/gaussians.py counts them); each
# linear layer 2 x inputs x outputs (a multiply and an add a weight, the
# bias taking the place of the first add): 64 -> 64 twice (8,192 each) and
# 64 -> 3 (384); the two ReLUs (64 each); the colour logits added (3) and
# the sigmoid (negate, exp, add, divide: 12).
_IN = EMBED_DIM + FEATURE_DIM + BASIS
APP_OPS_PER_ROW = (14 + 35 + 2 * _IN * MLP_WIDTH
                   + (HIDDEN_LAYERS - 1) * 2 * MLP_WIDTH * MLP_WIDTH
                   + 2 * MLP_WIDTH * 3 + HIDDEN_LAYERS * MLP_WIDTH + 3 + 12)
# Read once per row by the head: features 128, mean 12, colour logits 12;
# written once: the colour 12.
APP_BYTES_PER_ROW = 4 * FEATURE_DIM + 12 + 12 + 12


def make_weights(cfg: dict, seed: int, device) -> tuple:
    """({"rows", "app"}, alive): garden's rows as
    ``models/gaussians.py`` lays them out for ``seed`` (the same means,
    quaternions, scales, opacities and order), their SH replaced by
    features U(0, 1) (gsplat's initialisation; 0 in the never-used rows)
    and the logit of their base colour; the head's parameters
    (``head``)."""
    widths = (cfg["feature_dim"], cfg["embed_dim"], (cfg["sh_degree"] + 1) ** 2,
              cfg["mlp_width"], cfg["hidden_layers"])
    if widths != (FEATURE_DIM, EMBED_DIM, BASIS, MLP_WIDTH, HIDDEN_LAYERS):
        raise ValueError(f"the counts are of the widths {FEATURE_DIM, EMBED_DIM, BASIS}, "
                         f"{MLP_WIDTH} x {HIDDEN_LAYERS}; the configuration has {widths}")
    w, alive = G.make_weights(cfg, seed, device)
    cap = alive.shape[0]
    used = int(cfg["n_gaussians"]) + S.dead_rows(cfg)
    rgb = w.pop("sh0")[:, 0] * G.SH_C0 + 0.5
    del w["shN"]
    w["colors"] = torch.logit(rgb)
    # features drawn in the scene's own order, then put in the seed's,
    # as models/gaussians.py orders its used rows
    order = torch.randperm(used, generator=S.generator(seed, 1, device), device=device)
    g = S.generator(S.LAYOUT_SEED, 2, device)
    feats = torch.rand((used, FEATURE_DIM), generator=g, device=device)
    w["features"] = torch.zeros((cap, FEATURE_DIM), device=device)
    w["features"][:used] = feats[order]
    app = head(cfg, feats, g, device)
    del feats
    return {"rows": w, "app": app}, alive


def head(cfg: dict, feats: torch.Tensor, g: torch.Generator, device) -> dict:
    """The head's parameters in the port's names (``embeds``, ``w<i>``,
    ``b<i>``): embeddings N(0, 1), He-normal weights and PyTorch's default
    biases U(-1/sqrt(in), 1/sqrt(in)); the last layer scaled so that the
    logits it gives over a sample of the rows (``feats``), seen along
    random directions with the served embedding, have the standard
    deviation ``logit_std``."""
    app = {"embeds": torch.randn((int(cfg["n_images"]), EMBED_DIM), generator=g,
                                 device=device)}
    dims = [_IN] + [MLP_WIDTH] * HIDDEN_LAYERS + [3]
    for i, (di, do) in enumerate(zip(dims[:-1], dims[1:])):
        app[f"w{i}"] = torch.randn((di, do), generator=g, device=device) * math.sqrt(2.0 / di)
        app[f"b{i}"] = (torch.rand(do, generator=g, device=device) * 2 - 1) / math.sqrt(di)
    n = min(feats.shape[0], 1 << 16)
    d = torch.randn((n, 3), generator=g, device=device)
    d = d / torch.linalg.norm(d, dim=1, keepdim=True)
    rows = {"embed": app["embeds"][SERVED_IMAGE], "features": feats[:n],
            "head": _layers(app)}
    with R.precision("f32"):
        out = logits(rows, torch.arange(n, device=device), d, torch.float32)
    out = out - app[f"b{HIDDEN_LAYERS}"]
    app[f"w{HIDDEN_LAYERS}"] *= float(cfg["logit_std"]) / float(out.std())
    return app


def _layers(app: dict) -> list:
    return [(app[f"w{i}"], app[f"b{i}"]) for i in range(HIDDEN_LAYERS + 1)]


def program(weights, alive, cfg: dict, mix: dict, dev):
    """The port's serving entry over the weights: ``Renderer`` with the
    head's parameters (it serves the embedding of image 0)."""
    from splat_one_tpu_torch.app.viewer import Renderer

    return Renderer(weights["rows"], alive, int(cfg["width"]), int(cfg["height"]),
                    sh_degree=int(cfg["sh_degree"]), camera_model=mix["camera_model"],
                    device=dev, app_params=weights["app"])


def reference_rows(weights, alive):
    """The live rows, activated, with their features and colour logits,
    the served embedding and the head's layers."""
    live = {k: v[alive] for k, v in weights["rows"].items()}
    app = weights["app"]
    return dict(R.activate(live), features=live["features"], colors=live["colors"],
                embed=app["embeds"][SERVED_IMAGE], head=_layers(app))


def logits(rows, front, dirs, dtype):
    """The head's colour logits of the rows ``front`` seen along the unit
    directions ``dirs``, every operand in ``dtype``."""
    n = front.shape[0]
    h = torch.cat([rows["embed"].to(dtype).expand(n, EMBED_DIM),
                   rows["features"].to(dtype)[front], R.sh_basis3(dirs.to(dtype))], dim=-1)
    layers = rows["head"]
    for i, (w, b) in enumerate(layers):
        h = h @ w.to(dtype) + b.to(dtype)
        if i < len(layers) - 1:
            h = torch.relu(h)
    return h


def color(rows, front, dirs, dtype):
    """The colour of the rows ``front`` seen along ``dirs``:
    ``sigmoid(colors + logits)``."""
    return torch.sigmoid(rows["colors"].to(dtype)[front] + logits(rows, front, dirs, dtype))
