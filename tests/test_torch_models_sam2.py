"""Port parity: ``models/sam2_hiera.py`` and ``models/segmentation.py``
against the JAX package, on the CPU.

Both packages run the same weights: a random mini SAM 2.1 state dict in
the published torch layout (``tests/test_sam2_parity.py``'s ``MINI``
trunk, 16-wide decoder) converted by ``scripts/convert_weights.py``'s
``convert_sam2`` (called, not edited); ``random_checkpoint`` at ``MINI``
(the full 256-wide decoder), which both packages draw with the same
numpy generator; and JAX's compact ``init_encoder`` / ``init_decoder``
parameters carried across as numpy. ``MINI`` is added to both packages'
``CONFIGS`` for the module. JAX runs under ``jax.jit``.

- The faithful tier at 64x64: the four trunk stages, the neck levels,
  the embedding, ``s0`` / ``s1``, the mask logits, IoU and object score
  within 1e-4 abs; the predictor's masks equal wherever |logit| > 1e-4.
- ``random_checkpoint("hiera_s")``: JAX's keys, shapes and bits.
- A converted ``.npz``, an ``enc_*`` / ``dec_*`` one and none pick the
  same tier in both packages' ``build_predictor``.
- The compact tier at ``COMPACT_IMG_SIZE`` 256: the embedding within
  1e-4 abs (its entries reach ~50); the logits and IoU within 1e-4 of
  their largest entry (He-normal init without layer norms in the
  upscaler grows them to ~2e7; jitted and eager JAX differ by 5e-6 of
  it); the predictors' masks equal wherever |logit| > 1e-4 of the
  largest.
- ``ClassicalPredictor``: the same mask bits on ``tests/test_models.py``'s
  disk image and clicks; ``save_mask`` writes the same PNG.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, "scripts")

from convert_weights import convert_sam2  # noqa: E402
from splat_one_tpu.models import sam2_hiera as JS  # noqa: E402
from splat_one_tpu.models import segmentation as JSEG  # noqa: E402
from splat_one_tpu_torch.models import sam2_hiera as TS  # noqa: E402
from splat_one_tpu_torch.models import segmentation as TSEG  # noqa: E402
from test_sam2_parity import MINI, _sd_mini  # noqa: E402

ATOL = 1e-4
S = 64  # the mini input: trunk stages 16, 8, 4, 2


@pytest.fixture(autouse=True, scope="module")
def _mini_config():
    """One intra-op thread, and ``MINI`` in both packages' CONFIGS."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JS.CONFIGS, "mini", MINI)
        mp.setitem(TS.CONFIGS, "mini", MINI)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The mini state dict through convert_sam2 -> (npz path, its dict)."""
    d = tmp_path_factory.mktemp("sam2")
    torch.save(_sd_mini(np.random.default_rng(0)), d / "mini.pt")
    out = d / "mini.npz"
    convert_sam2(str(d / "mini.pt"), str(out))
    with np.load(out) as z:
        return str(out), {k: z[k] for k in z.files}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    img = rng.normal(scale=0.6, size=(1, S, S, 3)).astype(np.float32)
    coords = rng.uniform(0.1, 0.9, size=(1, 3, 2)).astype(np.float32)
    return img, coords, np.array([[1.0, 0.0, 1.0]], np.float32)


def _close(a, b, what, rel=False):
    """Within ATOL abs or, with ``rel``, ATOL of the largest entry of b."""
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max()
    assert err <= ATOL * (np.abs(b).max() if rel else 1.0), (what, err)


def _faithful_parity(npz):
    img, coords, labels = _inputs(1)
    pj = {k: jnp.asarray(v) for k, v in npz.items()}
    pt = TS.params_from_numpy(npz, "cpu")
    x = torch.as_tensor(img)
    feats_j = jax.jit(JS.hiera_forward, static_argnums=2)(pj, jnp.asarray(img), "mini")
    feats_t = TS.hiera_forward(pt, x, "mini")
    for i, (a, b) in enumerate(zip(feats_t, feats_j)):
        _close(a, b, f"trunk stage {i}")
    fpn_t = TS.neck_forward(pt, feats_t)
    for i, (a, b) in enumerate(zip(fpn_t, jax.jit(JS.neck_forward)(pj, feats_j))):
        _close(a, b, f"neck level {i}")
    emb_j, (s0_j, s1_j) = jax.jit(JS.image_encoder_forward, static_argnums=2)(
        pj, jnp.asarray(img), "mini")
    emb_t, (s0_t, s1_t) = TS.image_encoder_forward(pt, x, "mini")
    for a, b, what in ((emb_t, emb_j, "embed"), (s0_t, s0_j, "s0"), (s1_t, s1_j, "s1")):
        _close(a, b, what)
    out_j = jax.jit(JS.decode_masks)(pj, emb_j, (s0_j, s1_j), jnp.asarray(coords),
                                     jnp.asarray(labels))
    out_t = TS.decode_masks(pt, emb_t, (s0_t, s1_t), torch.as_tensor(coords),
                            torch.as_tensor(labels))
    for a, b, what in zip(out_t, out_j, ("logits", "iou", "object score")):
        _close(a, b, what)
    assert out_t[0].shape == (1, 4, S // 4, S // 4)


def test_faithful_tier_converted_mini(converted):
    _faithful_parity(converted[1])


def test_faithful_tier_random_checkpoint_mini():
    npz = TS.random_checkpoint("mini", seed=3)
    ref = JS.random_checkpoint("mini", seed=3)
    assert set(npz) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(npz[k], np.asarray(v))
    _faithful_parity(npz)


def test_random_checkpoint_hiera_s_manifest():
    pt, pj = TS.random_checkpoint("hiera_s", seed=0), JS.random_checkpoint("hiera_s", seed=0)
    assert list(pt) == list(pj)
    for k, v in pj.items():
        assert pt[k].dtype == np.float32 and pt[k].shape == v.shape, k
        np.testing.assert_array_equal(pt[k], np.asarray(v))


def _masks_agree(mt, mj, lt, lj):
    """The masks equal wherever the JAX logits are above the bar in size
    (1e-4, of the largest where that is above 1): the logit maps' signs
    equal there, and the PIL-resized masks equal where the two sign maps
    are equal everywhere."""
    lt, lj = np.asarray(lt), np.asarray(lj)
    bar = ATOL * max(1.0, float(np.abs(lj).max()))
    assert np.abs(lt - lj).max() <= bar
    sure = np.abs(lj) > bar
    np.testing.assert_array_equal((lt > 0)[sure], (lj > 0)[sure])
    if np.array_equal(lt > 0, lj > 0):
        np.testing.assert_array_equal(mt, mj)


def test_predictors_and_build_predictor(converted, tmp_path):
    path, _ = converted
    rng = np.random.default_rng(5)
    image = (rng.uniform(size=(50, 70, 3)) * 255).astype(np.uint8)
    pts, labs = np.array([[30.0, 20.0], [5.0, 40.0]]), np.array([1, 0])
    pj = JSEG.build_predictor(path, config="mini")
    pt = TSEG.build_predictor(path, config="mini", device="cpu")
    assert type(pj).__name__ == type(pt).__name__ == "SAM2Predictor"
    pj.img_size = pt.img_size = S
    for p in (pj, pt):
        p.set_image(image)
    for multi in (True, False):
        mj, ij, lj = pj.predict(pts, labs, multimask_output=multi)
        mt, it, lt = pt.predict(pts, labs, multimask_output=multi)
        assert mt.shape == mj.shape == ((3 if multi else 1), 50, 70)
        assert np.abs(it - ij).max() <= ATOL
        _masks_agree(mt, mj, lt, lj)
    # an enc_* / dec_* npz picks the compact tier, no file the classical one
    enc = JS.init_encoder(jax.random.PRNGKey(0))
    compact = tmp_path / "compact.npz"
    np.savez(compact, enc_neck_b=np.asarray(enc["neck_b"]) + 1.0)
    assert type(JSEG.build_predictor(str(compact))).__name__ == "HieraPredictor"
    hp = TSEG.build_predictor(str(compact), device="cpu")
    assert type(hp).__name__ == "HieraPredictor"
    np.testing.assert_array_equal(hp.enc_params["neck_b"].numpy(), np.ones(256, np.float32))
    for bp in (JSEG.build_predictor, TSEG.build_predictor):
        assert type(bp(str(tmp_path / "none.npz"))).__name__ == "ClassicalPredictor"


@pytest.fixture(scope="module")
def compact():
    k = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(k)
    enc = {key: np.asarray(v) for key, v in jax.jit(JS.init_encoder)(k1).items()}
    dec = {key: np.asarray(v) for key, v in jax.jit(JS.init_decoder)(k2).items()}
    return enc, dec


def test_compact_tier_matches_jax(compact, tmp_path):
    enc, dec = compact
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(1, 256, 256, 3)).astype(np.float32)
    coords = rng.uniform(0.1, 0.9, size=(1, 2, 2)).astype(np.float32)
    labels = np.array([[1.0, 0.0]], np.float32)
    et, dt = TS._tensors(enc, "cpu"), TS._tensors(dec, "cpu")
    emb_j = jax.jit(JS.encode_image)(enc, jnp.asarray(img))
    emb_t = TS.encode_image(et, torch.as_tensor(img))
    _close(emb_t, emb_j, "embedding")
    assert emb_t.shape == (1, 8, 8, 256)
    lj, ij = jax.jit(JS.compact_decode_masks)(enc, dec, emb_j, jnp.asarray(coords),
                                              jnp.asarray(labels))
    lt, it = TS.compact_decode_masks(et, dt, emb_t, torch.as_tensor(coords),
                                     torch.as_tensor(labels))
    _close(lt, lj, "logits", rel=True)
    _close(it, ij, "iou", rel=True)
    # both predictors load the same enc_* / dec_* file over their inits
    path = tmp_path / "compact.npz"
    np.savez(path, **{f"enc_{k}": v for k, v in enc.items()},
             **{f"dec_{k}": v for k, v in dec.items()})
    image = (rng.uniform(size=(40, 60, 3)) * 255).astype(np.uint8)
    pj, pt = JS.HieraPredictor(str(path)), TS.HieraPredictor(str(path), device="cpu")
    pj.set_image(image)
    pt.set_image(image)
    mj, ij, lj = pj.predict(np.array([[20.0, 10.0]]), np.array([1]))
    mt, it, lt = pt.predict(np.array([[20.0, 10.0]]), np.array([1]))
    assert mt.shape == mj.shape == (1, 40, 60)
    assert np.abs(it - ij).max() <= ATOL * np.abs(ij).max()
    _masks_agree(mt, mj, lt, lj)


def _disk():
    H = W = 96
    yy, xx = np.mgrid[0:H, 0:W]
    disk = ((yy - 48) ** 2 + (xx - 48) ** 2) < 20 ** 2
    img = np.repeat(np.where(disk[..., None], 0.9, 0.1).astype(np.float32), 3, axis=-1)
    return img, disk


def test_classical_predictor_bits_and_save_mask(tmp_path):
    img, disk = _disk()
    out = []
    for bp in (JSEG.build_predictor, TSEG.build_predictor):
        pred = bp()
        pred.set_image(img)
        out.append(pred.predict(np.array([[48, 48], [5, 5]]), np.array([1, 0])))
        # no negative click: the 60th-percentile cut
        out.append(pred.predict(np.array([[48, 48]]), np.array([1])))
    (mj, sj, _), (mj1, _, _), (mt, st, lt), (mt1, _, _) = out
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(mt1, mj1)
    np.testing.assert_array_equal(st, sj)
    assert lt is None and mt[0, 48, 48] and not mt[0, 5, 5]
    assert (mt[0] & disk).sum() / (mt[0] | disk).sum() > 0.7
    JSEG.save_mask(mj[0], str(tmp_path / "j" / "m.png"))
    TSEG.save_mask(mt[0], str(tmp_path / "t" / "m.png"))
    assert (tmp_path / "j" / "m.png").read_bytes() == (tmp_path / "t" / "m.png").read_bytes()
