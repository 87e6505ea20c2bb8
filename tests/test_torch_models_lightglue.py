"""Port parity: ``models/lightglue_tpu.py`` and ``models/transformer.py``
against the JAX package, on the CPU.

- ``transformer.py``: ``_linear``, ``_layernorm``, ``_attention``,
  ``_mlp`` (tanh GELU) and ``_block`` on JAX's ``_init_block`` params
  carried across: within 1e-6 abs (tolerance on the outputs' unit
  scale); the port's initializers give JAX's shapes.
- The trainable tier on JAX's ``init_lightglue`` params: ``sim``,
  ``ma`` and ``mb`` of ``lightglue_scores`` within 1e-4 abs (``sim`` is
  10x a cosine), ``match_lightglue`` equal (indices and mask).
- The checkpoint-faithful forward on the small official schema of
  ``tests/test_weight_converters.py`` (2 layers, d = 32, 2 heads), read
  through ``scripts/convert_weights.py lightglue``'s npz by both
  packages: the log-assignment within 1e-4 abs of JAX's and of the
  published torch forward; ``filter_matches_ckpt`` equal at two
  thresholds. The port's ``init_lightglue_ckpt`` schema (input 48 -> 64
  wide, 4 heads) runs in JAX's forward to the same matrix.
- ``load_lightglue``: an npz of JAX's trainable params loads in both and
  matches the same; no file gives JAX's shapes.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.models import lightglue_tpu as JL
from splat_one_tpu.models import transformer as JT
from splat_one_tpu_torch.models import lightglue_tpu as TL
from splat_one_tpu_torch.models import transformer as TT


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread, as the SfM test modules."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(d):
    return {k: np.asarray(v) for k, v in d.items()}


def test_transformer_blocks():
    p = {}
    JT._init_block(jax.random.PRNGKey(3), "b", 32, p)
    rng = np.random.default_rng(0)
    p["b_ln1_g"] = jnp.asarray(rng.uniform(0.5, 1.5, 32).astype(np.float32))
    p["b_ln2_b"] = jnp.asarray(rng.normal(0, 0.1, 32).astype(np.float32))
    pt = {k: torch.tensor(v) for k, v in _np(p).items()}
    x = rng.normal(size=(2, 17, 32)).astype(np.float32)
    y = rng.normal(size=(2, 9, 32)).astype(np.float32)
    xj, yj, xt, yt = jnp.asarray(x), jnp.asarray(y), torch.as_tensor(x), torch.as_tensor(y)
    pairs = [
        (JT._linear(p, "b_attn_q", xj), TT._linear(pt, "b_attn_q", xt)),
        (JT._layernorm(p, "b_ln1", xj), TT._layernorm(pt, "b_ln1", xt)),
        (JT._attention(p, "b_attn", xj, yj, 4), TT._attention(pt, "b_attn", xt, yt, 4)),
        (JT._mlp(p, "b_mlp", xj), TT._mlp(pt, "b_mlp", xt)),
        (JT._block(p, "b", xj, 4), TT._block(pt, "b", xt, 4)),
    ]
    for i, (a, b) in enumerate(pairs):
        a = np.asarray(a)
        assert np.abs(a - b.numpy()).max() <= 1e-6 * max(1.0, np.abs(a).max()), i
    q = {}
    TT._init_block(torch.Generator().manual_seed(0), "b", 32, q)
    assert {k: tuple(v.shape) for k, v in q.items()} == {k: tuple(v.shape) for k, v in p.items()}


@pytest.fixture(scope="module")
def trainable():
    pj = jax.jit(JL.init_lightglue, static_argnums=1)(jax.random.PRNGKey(0), 64)
    return pj, TL.params_from_numpy(_np(pj), "cpu")


def _pair(rng, n_a=60, n_b=50, d=64, size=(96, 80)):
    da = rng.normal(size=(n_a, d)).astype(np.float32)
    db = np.concatenate([da[:30] + 0.1 * rng.normal(size=(30, d)),
                         rng.normal(size=(n_b - 30, d))]).astype(np.float32)
    xa = rng.uniform(0, size, (n_a, 2)).astype(np.float32)
    xb = np.concatenate([xa[:30] + rng.normal(0, 1, (30, 2)),
                         rng.uniform(0, size, (n_b - 30, 2))]).astype(np.float32)
    return da, db, xa, xb, rng.uniform(size=n_a) > 0.1, rng.uniform(size=n_b) > 0.1


def test_trainable_tier(trainable):
    pj, pt = trainable
    da, db, xa, xb, va, vb = _pair(np.random.default_rng(1))
    na, nb = xa / np.float32([96, 80]), xb / np.float32([96, 80])
    sj = jax.jit(JL.lightglue_scores)(pj, *map(jnp.asarray, (da, db, na, nb, va, vb)))
    st = TL.lightglue_scores(pt, *map(torch.as_tensor, (da, db, na, nb, va, vb)))
    for a, b in zip(sj, st):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= 1e-4
    for min_score in (0.2, 0.0):
        mj = JL.match_lightglue(pj, da, db, xa, xb, (96, 80), (96, 80), va, vb, min_score)
        mt = TL.match_lightglue(pt, da, db, xa, xb, (96, 80), (96, 80), va, vb, min_score)
        np.testing.assert_array_equal(mt[0], mj[0])
        np.testing.assert_array_equal(mt[1], mj[1])
    assert mt[1].sum() > 0
    shapes = {k: tuple(v.shape) for k, v in TL.init_lightglue(64, device="cpu").items()}
    assert shapes == {k: tuple(v.shape) for k, v in pj.items()}


@pytest.fixture(scope="module")
def official(tmp_path_factory):
    """The small official schema through the converter: the torch state
    dict and the npz both packages read."""
    sys.path.insert(0, "scripts")
    from convert_weights import convert_lightglue
    from test_weight_converters import _torch_lightglue_sd

    sd = _torch_lightglue_sd(np.random.default_rng(0), d=32, heads=2, layers=2)
    d = tmp_path_factory.mktemp("lg")
    torch.save(sd, d / "mini.pth")
    convert_lightglue(str(d / "mini.pth"), str(d / "mini.npz"))
    return sd, str(d / "mini.npz")


def test_faithful_forward(official):
    from test_weight_converters import _torch_lightglue_forward

    sd, path = official
    z = np.load(path)
    pj = {k: jnp.asarray(z[k]) for k in z.files}
    pt = TL.load_lightglue(path, desc_dim=32, device="cpu")
    assert TL.is_faithful(pt)
    rng = np.random.default_rng(2)
    m, n, size = 40, 37, (640.0, 480.0)
    k0 = rng.uniform(0, 640, (m, 2)).astype(np.float32)
    k1 = rng.uniform(0, 480, (n, 2)).astype(np.float32)
    d0 = rng.normal(scale=0.5, size=(m, 32)).astype(np.float32)
    d1 = np.concatenate([d0[:20] + 0.05 * rng.normal(size=(20, 32)),
                         rng.normal(scale=0.5, size=(n - 20, 32))]).astype(np.float32)
    sj = np.asarray(JL.lightglue_forward_ckpt(pj, k0, k1, d0, d1, size, size, n_heads=2))
    st = TL.lightglue_forward_ckpt(pt, k0, k1, d0, d1, size, size, n_heads=2)
    assert st.shape == (m + 1, n + 1)
    assert np.abs(st.numpy() - sj).max() <= 1e-4
    with torch.no_grad():
        ref = _torch_lightglue_forward(sd, torch.tensor(k0), torch.tensor(k1), torch.tensor(d0),
                                       torch.tensor(d1), size, d=32, heads=2, layers=2).numpy()
    assert np.abs(st.numpy() - ref).max() <= 1e-4
    for thr in (0.1, 0.0):
        mj, okj = JL.filter_matches_ckpt(jnp.asarray(sj), thr)
        mt, okt = TL.filter_matches_ckpt(st, thr)
        np.testing.assert_array_equal(mt, mj)
        np.testing.assert_array_equal(okt, okj)
    assert okt.sum() > 0


def test_port_schema_runs_in_jax():
    pt = TL.init_lightglue_ckpt(input_dim=48, descriptor_dim=64, n_layers=2, n_heads=4,
                                device="cpu")
    pj = {k: jnp.asarray(v) for k, v in TL.params_to_numpy(pt).items()}
    rng = np.random.default_rng(3)
    k0, k1 = rng.uniform(0, 100, (30, 2)), rng.uniform(0, 100, (25, 2))
    d0, d1 = rng.normal(size=(30, 48)), rng.normal(size=(25, 48))
    sj = np.asarray(JL.lightglue_forward_ckpt(pj, k0, k1, d0, d1, (100, 90), (100, 90)))
    st = TL.lightglue_forward_ckpt(pt, k0, k1, d0, d1, (100, 90), (100, 90)).numpy()
    assert st.shape == (31, 26) and np.isfinite(st).all()
    assert np.abs(st - sj).max() <= 1e-4


def test_load_lightglue_npz(tmp_path, trainable):
    pj, _ = trainable
    np.savez(tmp_path / "lg.npz", **_np(pj))
    pj2 = JL.load_lightglue(str(tmp_path / "lg.npz"), desc_dim=64)
    pt2 = TL.load_lightglue(str(tmp_path / "lg.npz"), desc_dim=64, device="cpu")
    assert not TL.is_faithful(pt2)
    da, db, xa, xb, va, vb = _pair(np.random.default_rng(5))
    mj = JL.match_lightglue(pj2, da, db, xa, xb, (96, 80), (96, 80), va, vb)
    mt = TL.match_lightglue(pt2, da, db, xa, xb, (96, 80), (96, 80), va, vb)
    np.testing.assert_array_equal(mt[0], mj[0])
    np.testing.assert_array_equal(mt[1], mj[1])
    fresh = TL.load_lightglue(None, desc_dim=64, device="cpu")
    assert {k: tuple(v.shape) for k, v in fresh.items()} == {
        k: tuple(v.shape) for k, v in pj.items()}
