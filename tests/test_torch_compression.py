"""Port parity: ``train/compression`` (PNG splat compression) against the
JAX package. ``compress`` writes byte-identical files and metadata, each
package decompresses the other's directory to arrays equal to its own
round trip (exact: the port's module is a numpy copy), and the round trip
stays within the codec's quantization steps."""

import filecmp
import json
import os

import numpy as np
import pytest

from splat_one_tpu.train import compression as jcomp
from splat_one_tpu_torch.train import compression as comp


def _splats(n=300, cap=400, sh_bands=15, seed=0):
    rng = np.random.default_rng(seed)
    params = {"means": rng.normal(size=(cap, 3)), "scales": rng.normal(size=(cap, 3)) - 3,
              "quats": rng.normal(size=(cap, 4)), "opacities": rng.normal(size=cap),
              "sh0": rng.normal(size=(cap, 1, 3)), "shN": rng.normal(size=(cap, sh_bands, 3))}
    alive = np.zeros(cap, bool)
    alive[rng.choice(cap, n, replace=False)] = True
    return {k: v.astype(np.float32) for k, v in params.items()}, alive


@pytest.mark.parametrize("sh_bands", [3, 15])
def test_compress_matches_jax(sh_bands, tmp_path):
    params, alive = _splats(sh_bands=sh_bands)
    meta = comp.compress(str(tmp_path / "t"), params, alive)
    meta_j = jcomp.compress(str(tmp_path / "j"), params, alive)
    assert meta == meta_j
    files = sorted(os.listdir(tmp_path / "t"))
    assert files == sorted(os.listdir(tmp_path / "j"))
    assert len(files) == 7 + sh_bands  # meta, means hi/lo, scales, quats, opac, sh0, shN
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "t", tmp_path / "j", files, shallow=False)
    assert not mismatch and not errors
    with open(tmp_path / "t" / "meta.json") as f:
        assert json.load(f)["n"] == int(alive.sum())

    back, alive_b = comp.decompress(str(tmp_path / "j"))
    back_j, alive_bj = jcomp.decompress(str(tmp_path / "t"))
    assert back.keys() == back_j.keys()
    for k in back:
        np.testing.assert_array_equal(back[k], back_j[k])
        assert back[k].dtype == back_j[k].dtype == np.float32
    np.testing.assert_array_equal(alive_b, alive_bj)

    # round trip: the decompressed splats are the alive ones, quantized
    idx = np.nonzero(alive)[0]
    order = np.argsort(comp._morton3(
        (params["means"][idx] - params["means"][idx].min(0))
        / (params["means"][idx].max(0) - params["means"][idx].min(0))))
    src = {k: v[idx[order]] for k, v in params.items()}
    for k, bits in (("means", 16), ("scales", 8), ("opacities", 8), ("sh0", 8), ("shN", 8)):
        span = src[k].max() - src[k].min()
        assert np.abs(back[k] - src[k]).max() <= span / (2 ** bits - 1) + 1e-6, k


def test_compress_refuses_appearance_splats(tmp_path):
    params, alive = _splats()
    params = {k: v for k, v in params.items() if k not in ("sh0", "shN")}
    params["features"] = np.zeros((400, 32), np.float32)
    with pytest.raises(NotImplementedError):
        comp.compress(str(tmp_path), params, alive)
