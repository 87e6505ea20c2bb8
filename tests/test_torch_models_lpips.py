"""Port parity: ``models/lpips.py`` and LPIPS in ``Trainer.eval``, against
the JAX package on the CPU.

One weight file serves both packages: a random AlexNet + linear-head
state dict in the published torch layouts, converted by
``scripts/convert_weights.py``'s ``convert_lpips`` (called, not edited),
as ``tests/test_weight_converters.py`` builds it.

- Each of the five feature maps within 1e-5 of its largest entry, and
  the LPIPS value within 1e-5 rel of JAX's (jitted), on 2 image pairs at
  64x48.
- ``Trainer.eval`` with ``DEFAULT_WEIGHTS`` pointing at the file reports
  the mean over the val views of JAX's ``lpips`` on the same render and
  image, within 1e-5 rel; without the file it reports None, as JAX's.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "scripts")

from convert_weights import convert_lpips  # noqa: E402
from splat_one_tpu.models import lpips as JL  # noqa: E402
from splat_one_tpu_torch.data.synthetic import make_synthetic_scene  # noqa: E402
from splat_one_tpu_torch.models import lpips as TL  # noqa: E402
from splat_one_tpu_torch.train.config import Config  # noqa: E402
from splat_one_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_weight_converters import _torch_alexnet_sd  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    rng = np.random.default_rng(0)
    d = tmp_path_factory.mktemp("lpips")
    lin = {f"lins.{i}.model.1.weight": torch.tensor(
        rng.uniform(0.0, 0.2, size=(1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate([64, 192, 384, 256, 256])}
    torch.save(_torch_alexnet_sd(rng), d / "alex.pth")
    torch.save(lin, d / "lin.pth")
    out = d / "lpips_alex.npz"
    convert_lpips(str(d / "alex.pth"), str(d / "lin.pth"), str(out))
    return str(out)


def test_params_and_gate(weights):
    assert TL.load_weights("/nonexistent.npz", device="cpu") is None
    assert not TL.lpips_available("/nonexistent.npz") and TL.lpips_available(weights)
    pj = JL.load_weights(weights)
    pt = TL.load_weights(weights, device="cpu")
    assert set(pt) == set(pj)
    for k, v in pj.items():
        a = np.asarray(v)
        want = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a
        np.testing.assert_array_equal(pt[k].numpy(), want)


def test_lpips_matches_jax(weights):
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(2, 48, 64, 3)).astype(np.float32)
    y = rng.uniform(size=(2, 48, 64, 3)).astype(np.float32)
    pj = JL.load_weights(weights)
    pt = TL.load_weights(weights, device="cpu")
    fj = jax.jit(JL._alex_features)(pj, jnp.asarray(x * 2 - 1))
    ft = TL._alex_features(pt, torch.as_tensor(x * 2 - 1))
    for i, (a, b) in enumerate(zip(ft, fj)):
        b = np.asarray(b).transpose(0, 3, 1, 2)
        assert a.shape == b.shape, i
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max(), i
    vj = float(jax.jit(JL.lpips)(pj, jnp.asarray(x), jnp.asarray(y)))
    vt = float(TL.lpips(pt, torch.as_tensor(x), torch.as_tensor(y)))
    assert vj > 0 and abs(vt - vj) <= 1e-5 * vj, (vt, vj)


def test_trainer_eval_reports_lpips(weights, tmp_path, monkeypatch):
    scene, _ = make_synthetic_scene(n_gaussians=300, n_cameras=6, width=64, height=48,
                                    n_points=150, device="cpu")
    tr = Trainer(Config(max_steps=0, eval_steps=[], save_steps=[], capacity=512, sh_degree=1,
                        camera_model="pinhole", test_every=3,
                        result_dir=str(tmp_path / "r")), scene, device="cpu")
    monkeypatch.setattr(TL, "DEFAULT_WEIGHTS", str(tmp_path / "none.npz"))
    assert tr.eval(0)["lpips"] is None
    monkeypatch.setattr(TL, "DEFAULT_WEIGHTS", weights)
    stats = tr.eval(0)
    pj = JL.load_weights(weights)
    fn = jax.jit(JL.lpips)
    want = []
    for i in tr.val_idx:
        b = tr._batch(np.array([i]))
        rgb, _, _ = tr._eval_render(tr.state, b["camtoworld"], b["K"], b["image_id"])
        want.append(float(fn(pj, jnp.asarray(rgb.numpy()), jnp.asarray(b["image"].numpy()))))
    assert len(want) == 2 and np.isfinite(stats["lpips"])
    assert abs(stats["lpips"] - np.mean(want)) <= 1e-5 * np.mean(want), (stats, want)
