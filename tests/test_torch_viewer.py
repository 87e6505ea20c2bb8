"""The port's serving entry: checkpoint loading, make_render_fn, isolation.

- A JAX-format Trainer checkpoint (npz with ``params['...']`` keys and
  ``alive``), written from seeded numpy, renders through
  ``load_checkpoint_params`` -> ``make_render_fn(device="cpu")`` within
  1e-5 relative of JAX ``rasterization`` given the Trainer's
  ``_render_view_alt`` activations. Expected depth is compared times
  alpha: ED divides by alpha, which near zero magnifies last-ulp
  differences past any fixed tolerance.
- Importing the port (every submodule), chip_smoke.py,
  raster_anatomy.py and reduce_anatomy.py loads neither ``jax`` nor
  ``splat_one_tpu``, and no port source imports them.
- ``make_render_fn`` defaults to CUDA and raises without it.
"""

import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.core.transforms import invert_se3 as jinvert_se3
from splat_one_tpu.ops.stream_isect import StreamCaps, supertile_grid
from splat_one_tpu.render.rasterization import rasterization as jras
from splat_one_tpu_torch.app import viewer

REPO = Path(__file__).resolve().parents[1]
W, H = 64, 48


def _checkpoint(tmp_path, n=400, cap=450):
    rng = np.random.default_rng(3)
    params = {
        "means": rng.uniform(-1, 1, (cap, 3)).astype(np.float32) + [0, 0, 4],
        "quats": rng.normal(size=(cap, 4)).astype(np.float32),
        "scales": np.log(np.exp(rng.uniform(-3.5, -2.0, (cap, 3))) * 3).astype(np.float32),
        "opacities": rng.normal(size=cap).astype(np.float32),
        "sh0": (rng.normal(size=(cap, 1, 3)) * 0.5).astype(np.float32),
        "shN": (rng.normal(size=(cap, 15, 3)) * 0.1).astype(np.float32),
    }
    alive = np.arange(cap) < n
    flat = {f"params['{k}']": v for k, v in params.items()}
    flat.update({f"opt_m['{k}']": np.zeros_like(v) for k, v in params.items()})
    flat.update(alive=alive, step=np.asarray(7), opt_count=np.asarray(7))
    path = tmp_path / "ckpt_7.npz"
    np.savez(path, **flat)
    return path, params, alive


@pytest.mark.parametrize("model", ["pinhole", "spherical"])
def test_checkpoint_render_matches_jax(tmp_path, model):
    path, params, alive = _checkpoint(tmp_path)
    p, a = viewer.load_checkpoint_params(str(path), device="cpu")
    assert sorted(p) == sorted(params)
    render_fn = viewer.make_render_fn(p, a, W, H, sh_degree=3, camera_model="pinhole",
                                      device="cpu")
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.1, -0.05, 0.2]
    K = np.float32([[50.0, 0, W / 2], [0, 50.0, H / 2], [0, 0, 1]])
    rgb, depth, alpha, info = render_fn.render(c2w, K, model)

    # JAX Trainer._render_view_alt's computation (caps as the Trainer sizes
    # them at its default 3 supertiles per gaussian)
    _, _, sw, sh = supertile_grid(W, H, 16)
    caps = StreamCaps.choose(len(alive), 1, sw * sh)

    @jax.jit
    def jax_render(jp, alive, c2w, K):
        out, alpha, _ = jras(
            jp["means"], jp["quats"], jnp.exp(jp["scales"]),
            jnp.where(alive, jax.nn.sigmoid(jp["opacities"]), 0.0),
            jnp.concatenate([jp["sh0"], jp["shN"]], axis=1),
            jinvert_se3(c2w[None]), K[None], W, H,
            sh_degree=3, camera_model=model, render_mode="RGB+ED", caps=caps)
        return out[0], alpha[0]

    out, alpha_j = map(np.asarray, jax_render(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(alive),
        jnp.asarray(c2w), jnp.asarray(K)))
    for got, want in ((rgb, out[..., :3]), (alpha, alpha_j),
                      (depth * alpha, out[..., 3:] * alpha_j)):
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
    assert float(alpha.max()) > 0.1 and not bool(info["overflow"])
    img = render_fn(c2w, K, model)
    assert img.dtype == np.uint8 and img.shape == (H, W, 3)
    np.testing.assert_array_equal(
        img, (np.clip(rgb.numpy(), 0, 1) * 255).astype(np.uint8))


def test_port_never_imports_jax():
    pkg = REPO / "splat_one_tpu_torch"
    mods = [m.name for m in pkgutil.walk_packages([str(pkg)], "splat_one_tpu_torch.")]
    assert {"splat_one_tpu_torch.ops.stream_raster", "splat_one_tpu_torch.ops.seg_reduce",
            "splat_one_tpu_torch.ops.ssim", "splat_one_tpu_torch.train.trainer",
            "splat_one_tpu_torch.train.strategy", "splat_one_tpu_torch.train.optimizers",
            "splat_one_tpu_torch.train.losses", "splat_one_tpu_torch.train.config",
            "splat_one_tpu_torch.utils.tensorboard",
            "splat_one_tpu_torch.utils.device", "splat_one_tpu_torch.ops.intersect",
            "splat_one_tpu_torch.ops.tile_raster", "splat_one_tpu_torch.ops.seg_broadcast",
            "splat_one_tpu_torch.data.synthetic", "splat_one_tpu_torch.parallel.comm",
            "splat_one_tpu_torch.parallel.multihost",
            "splat_one_tpu_torch.parallel.train_step",
            "splat_one_tpu_torch.parallel.tile_sharded",
            "splat_one_tpu_torch.parallel.ring_sharded",
            "splat_one_tpu_torch.sfm.features", "splat_one_tpu_torch.sfm.matching",
            "splat_one_tpu_torch.sfm.geometry", "splat_one_tpu_torch.sfm.tracks",
            "splat_one_tpu_torch.sfm.ba", "splat_one_tpu_torch.sfm.reconstruct",
            "splat_one_tpu_torch.app.exif", "splat_one_tpu_torch.app.image_processing",
            "splat_one_tpu_torch.app.camera_models", "splat_one_tpu_torch.app.pipeline",
            "splat_one_tpu_torch.app.cli", "splat_one_tpu_torch.sfm.orb",
            "splat_one_tpu_torch.sfm.akaze", "splat_one_tpu_torch.sfm.surf",
            "splat_one_tpu_torch.sfm.rigs", "splat_one_tpu_torch.models.transformer",
            "splat_one_tpu_torch.models.aliked_tpu",
            "splat_one_tpu_torch.models.lightglue_tpu", "splat_one_tpu_torch.models.lpips",
            "splat_one_tpu_torch.models.segmentation", "splat_one_tpu_torch.models.sam2_hiera",
            "splat_one_tpu_torch.models.depth_tpu"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r} + ['chip_smoke', 'raster_anatomy', 'reduce_anatomy',\n"
        "                     'lightglue_precision']:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'splat_one_tpu' or m.startswith('splat_one_tpu.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
    imp = re.compile(r"^\s*(import|from)\s+(jax|splat_one_tpu)(\s|\.|$)", re.M)
    scripts = ("chip_smoke.py", "raster_anatomy.py", "reduce_anatomy.py",
               "lightglue_precision.py")
    for f in list(pkg.rglob("*.py")) + [REPO / f for f in scripts]:
        assert not imp.search(f.read_text()), f


def test_make_render_fn_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    p = {k: torch.zeros(4, 3) for k in ("means", "scales")}
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.make_render_fn(p, torch.ones(4, dtype=torch.bool), W, H)
    with pytest.raises(RuntimeError, match="CUDA"):
        viewer.params_from_numpy({"means": np.zeros((4, 3))}, np.ones(4, bool))
