"""The learned models' training tiers: gradients through the port's
``models/aliked_tpu.aliked_forward`` and ``models/lightglue_tpu.lightglue_scores``
against ``jax.grad`` of the JAX package's, on the CPU.

- The two losses of ``tests/test_models_trainability.py`` (ALIKED's
  weighted blob regression on 8 x 32 x 32 images, desc_dim 32;
  LightGlue's cross-entropy over a permutation plus the matchability term,
  K = 12, D = 32) on JAX's initial parameters carried across
  (``params_from_numpy``): every parameter's gradient within 1e-4 of its
  largest |entry|, and the loss within 1e-5 rel. ALIKED's blob loss never
  reads the descriptor head, so JAX's gradients there are zeros and the
  port's are unused; a second ALIKED loss adds a descriptor term so
  that every parameter gets a gradient (none is cut by a ``detach``,
  a ``no_grad`` or an in-place op).
- One ``torch.optim.Adam`` step, then a second, against ``optax.adam``
  on the same parameters and gradients (``eps`` after the bias
  correction in both): each entry within 1e-5 x lr plus one f32 spacing
  of the entry a step (the two round the update and the sum apart). optax forms the bias correction 1 - b2^t in
  float32 (1 - 0.999 is 1.3e-5 rel off) and torch in float64, which moves
  a step by ~6.5e-6 x lr.
- The port's own loops at the JAX tests' sizes and rates (ALIKED: Adam
  3e-4, 150 steps; LightGlue: Adam 2e-3, 300 steps over 24 seeded
  pairs), from the port's seeded initialization, meet the JAX tests'
  assertions: the loss below a third of its start and the score map's
  peak on a blob; the loss below its start and held-out accuracy > 0.8.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from splat_one_tpu.models import aliked_tpu as JA
from splat_one_tpu.models import lightglue_tpu as JL
from splat_one_tpu_torch.models import aliked_tpu as TA
from splat_one_tpu_torch.models import lightglue_tpu as TL
from test_models_trainability import _blob_image

GRAD_RTOL = 1e-4  # of each gradient's largest |entry|
LOSS_RTOL = 1e-5
ADAM_LR_TOL = 1e-5  # Adam vs optax, a step: of lr (plus one f32 spacing)
K, D = 12, 32  # LightGlue's keypoints and descriptor width


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread (LightGlue's thousands of tiny ops spin-wait
    with more); ALIKED's loop takes two (``_conv_threads``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _conv_threads():
    """Two intra-op threads for ALIKED's convolutions; more would
    oversubscribe the cores that the other test workers share."""
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(1)


def _blobs():
    rng = np.random.default_rng(0)
    imgs, tgts = zip(*(_blob_image(rng) for _ in range(8)))
    return np.stack(imgs)[..., None], np.stack(tgts)


def _desc_weights(shape):
    return np.random.default_rng(5).normal(size=shape).astype(np.float32)


def _aliked_loss_j(p, imgs, tgts, r=None):
    score, desc = JA.aliked_forward(p, imgs)
    w = 1.0 + 30.0 * tgts
    loss = jnp.mean(w * (score - tgts) ** 2) / jnp.mean(w)
    return loss if r is None else loss + 0.1 * jnp.mean(desc * r)


def _aliked_loss_t(p, imgs, tgts, r=None):
    score, desc = TA.aliked_forward(p, imgs)
    w = 1.0 + 30.0 * tgts
    loss = torch.mean(w * (score - tgts) ** 2) / torch.mean(w)
    return loss if r is None else loss + 0.1 * torch.mean(desc * r)


def _lg_sample(seed):
    r = np.random.default_rng(seed)
    da = r.normal(size=(K, D)).astype(np.float32)
    da /= np.linalg.norm(da, axis=1, keepdims=True)
    perm = r.permutation(K)
    db = da[perm] + r.normal(0, 0.1, (K, D)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    xa = r.uniform(0, 1, (K, 2)).astype(np.float32)
    # db[j] = da[perm[j]]: row i of A matches column inv_perm[i]
    return da, db, xa, xa[perm], np.argsort(perm)


def _lg_loss_j(p, da, db, xa, xb, label):
    valid = jnp.ones((K,), bool)
    sim, ma, mb = JL.lightglue_scores(p, da, db, xa, xb, valid, valid)
    ce = -jnp.mean(jax.nn.log_softmax(sim, axis=1)[jnp.arange(K), label])
    match = -jnp.mean(jnp.log(ma + 1e-6) + jnp.log(mb + 1e-6))
    return ce + 0.1 * match


def _lg_loss_t(p, da, db, xa, xb, label):
    valid = torch.ones(K, dtype=torch.bool)
    sim, ma, mb = TL.lightglue_scores(p, da, db, xa, xb, valid, valid)
    ce = -torch.mean(torch.log_softmax(sim, dim=1)[torch.arange(K), label])
    match = -torch.mean(torch.log(ma + 1e-6) + torch.log(mb + 1e-6))
    return ce + 0.1 * match


@pytest.fixture(scope="module")
def aliked_jax():
    """JAX's initial parameters, inputs, and its (loss, gradients) of the
    blob loss and of the blob + descriptor loss."""
    imgs, tgts = _blobs()
    params = JA.init_aliked(jax.random.PRNGKey(0), desc_dim=32)
    r = _desc_weights(imgs.shape[:3] + (32,))
    vg = jax.jit(jax.value_and_grad(_aliked_loss_j))
    out = {"blob": vg(params, imgs, tgts), "blob+desc": vg(params, imgs, tgts, r)}
    out = {k: (float(l), {n: np.asarray(v) for n, v in g.items()}) for k, (l, g) in out.items()}
    return {n: np.asarray(v) for n, v in params.items()}, imgs, tgts, r, out


@pytest.fixture(scope="module")
def lightglue_jax():
    params = JL.init_lightglue(jax.random.PRNGKey(2), desc_dim=D)
    batch = _lg_sample(0)
    loss, grads = jax.jit(jax.value_and_grad(_lg_loss_j))(params, *batch)
    return ({n: np.asarray(v) for n, v in params.items()}, batch, float(loss),
            {n: np.asarray(v) for n, v in grads.items()})


def _grads_close(want, got):
    """Each gradient within GRAD_RTOL of its largest |entry| (JAX's zero
    gradients: the port's unused or zero)."""
    for name, g in want.items():
        t = got[name]
        scale = np.abs(g).max()
        if scale == 0:
            assert t is None or not t.any(), name
            continue
        err = np.abs(t - g).max()
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("loss", ["blob", "blob+desc"])
def test_aliked_grads_match_jax(aliked_jax, loss):
    params, imgs, tgts, r, out = aliked_jax
    want_loss, want = out[loss]
    pt = TA.params_from_numpy(params, "cpu")
    names = list(pt)
    leaves = [pt[n].requires_grad_() for n in names]
    lt = _aliked_loss_t(pt, torch.as_tensor(imgs), torch.as_tensor(tgts),
                        None if loss == "blob" else torch.as_tensor(r))
    assert abs(lt.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    grads = torch.autograd.grad(lt, leaves, allow_unused=loss == "blob")
    if loss == "blob+desc":  # every parameter reached
        assert all(g is not None for g in grads)
    got = {n: None if g is None else g.numpy() for n, g in zip(names, grads)}
    # OIHW -> JAX's HWIO
    got = {n: g if g is None or g.ndim != 4 else g.transpose(2, 3, 1, 0) for n, g in got.items()}
    _grads_close(want, got)


def test_lightglue_grads_match_jax(lightglue_jax):
    params, batch, want_loss, want = lightglue_jax
    pt = TL.params_from_numpy(params, "cpu")
    names = list(pt)
    leaves = [pt[n].requires_grad_() for n in names]
    lt = _lg_loss_t(pt, *(torch.as_tensor(x) for x in batch))
    assert abs(lt.item() - want_loss) <= LOSS_RTOL * abs(want_loss)
    grads = torch.autograd.grad(lt, leaves)  # every parameter reached
    _grads_close(want, {n: g.numpy() for n, g in zip(names, grads)})


def test_adam_steps_match_optax(lightglue_jax):
    """Two steps: the first at JAX's gradients, the second at a seeded
    perturbation of them (a second bias correction)."""
    params, _, _, grads = lightglue_jax
    rng = np.random.default_rng(7)
    g2 = {n: (0.5 * g + rng.normal(0, 1e-3, g.shape)).astype(np.float32)
          for n, g in grads.items()}
    opt = optax.adam(2e-3)
    pj = {n: jnp.asarray(v) for n, v in params.items()}
    state = opt.init(pj)

    @jax.jit
    def step(p, s, g):
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s

    pt = {n: torch.tensor(v, requires_grad=True) for n, v in params.items()}
    topt = torch.optim.Adam(pt.values(), lr=2e-3)
    for g in (grads, g2):
        pj, state = step(pj, state, g)
        for n, p in pt.items():
            p.grad = torch.tensor(g[n])
        topt.step()
    for n, p in pt.items():
        want = np.asarray(pj[n])
        assert not np.array_equal(want, params[n]), n
        err = np.abs(p.detach().numpy() - want)
        bar = 2 * (ADAM_LR_TOL * 2e-3 + np.spacing(np.abs(want)))
        assert (err <= bar).all(), (n, err.max())


def test_aliked_learns_blobs():
    imgs, tgts = (torch.as_tensor(x) for x in _blobs())
    params = {n: p.requires_grad_() for n, p in TA.init_aliked(32, device="cpu").items()}
    opt = torch.optim.Adam(params.values(), lr=3e-4)
    with torch.no_grad():
        l0 = _aliked_loss_t(params, imgs, tgts).item()
    with _conv_threads():
        for _ in range(150):
            opt.zero_grad()
            loss = _aliked_loss_t(params, imgs, tgts)
            loss.backward()
            opt.step()
    assert loss.item() < l0 / 3
    # the trained detector localizes: the score map's peak sits on a blob
    with torch.no_grad():
        score, _ = TA.aliked_forward(params, imgs[:1])
    peak = int(torch.argmax(score[0]))
    assert float(tgts[0].flatten()[peak]) > 0.3


def test_lightglue_learns_permutation():
    params = {n: p.requires_grad_() for n, p in TL.init_lightglue(D, device="cpu").items()}
    opt = torch.optim.Adam(params.values(), lr=2e-3)
    batches = [[torch.as_tensor(x) for x in _lg_sample(i)] for i in range(24)]
    with torch.no_grad():
        l0 = _lg_loss_t(params, *batches[0]).item()
    for it in range(300):
        opt.zero_grad()
        loss = _lg_loss_t(params, *batches[it % 24])
        loss.backward()
        opt.step()
    assert loss.item() < l0
    # the learned matcher recovers the permutation on a held-out pair
    da, db, xa, xb, label = (torch.as_tensor(x) for x in _lg_sample(999))
    valid = torch.ones(K, dtype=torch.bool)
    with torch.no_grad():
        sim, _, _ = TL.lightglue_scores(params, da, db, xa, xb, valid, valid)
    acc = float((torch.argmax(sim, dim=1) == label).float().mean())
    assert acc > 0.8, f"held-out matching accuracy {acc}"
