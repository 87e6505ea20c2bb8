"""Port parity: the training building blocks against the JAX package.

Same seeded numpy inputs through both packages:
- ``ssim``, ``image_loss``, ``depth_loss``, ``regularizers`` and
  ``psnr``, values and (for the image loss) gradients, within 1e-5
  relative: the window blurs are convolutions that XLA and PyTorch sum in
  different orders (TF32 is off); ``d_ssim_loss`` = 1 - SSIM cancels, so
  it is held to 1e-5 absolute;
- ``adam_update`` (with and without ``visible_mask``), ``means_lr_decay``,
  ``surgery_zero_moments`` within 1e-6 relative;
- ``strategy_update``, ``default_refine`` (the JAX function's own normal
  draws, made from its key, are fed to the port) and ``reset_opacity``:
  masks and counts exactly, values within 1e-6 relative;
- ``Config.adjust_steps``, ``n_alive`` and ``grow_capacity`` exactly.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from splat_one_tpu.core import gaussians as jg
from splat_one_tpu.ops import ssim as jssim
from splat_one_tpu.train import config as jconfig
from splat_one_tpu.train import losses as jl
from splat_one_tpu.train import optimizers as jopt
from splat_one_tpu.train import strategy as js
from splat_one_tpu_torch.core import gaussians as tg
from splat_one_tpu_torch.ops import ssim as tssim
from splat_one_tpu_torch.train import config as tconfig
from splat_one_tpu_torch.train import losses as tl
from splat_one_tpu_torch.train import optimizers as topt
from splat_one_tpu_torch.train import strategy as ts

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the plain versions run many small ops, which
    gain nothing from threads, and the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(autouse=True)
def _no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, np.abs(got - want).max() / scale


def _images(seed, b=2, h=40, w=48):
    rng = np.random.default_rng(seed)
    gt = rng.uniform(size=(b, h, w, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(scale=0.1, size=gt.shape), 0, 1).astype(np.float32)
    return pred, gt


def test_ssim_and_image_loss():
    pred, gt = _images(0)
    _close(tssim.ssim(torch.as_tensor(pred), torch.as_tensor(gt)),
           jssim.ssim(jnp.asarray(pred), jnp.asarray(gt)), 1e-5)
    # 1 - SSIM cancels (SSIM ~ 0.95 here): held to 1e-5 absolute
    d_t = tssim.d_ssim_loss(torch.as_tensor(pred), torch.as_tensor(gt))
    d_j = jssim.d_ssim_loss(jnp.asarray(pred), jnp.asarray(gt))
    assert abs(float(d_t) - float(d_j)) <= 1e-5
    p = torch.tensor(pred, requires_grad=True)
    out_t = tl.image_loss(p, torch.as_tensor(gt), 0.3)
    out_t["loss"].backward()
    out_j = jl.image_loss(jnp.asarray(pred), jnp.asarray(gt), 0.3)
    for k in ("loss", "l1", "ssim"):
        _close(out_t[k], out_j[k], 1e-5)
    g_j = jax.grad(lambda x: jl.image_loss(x, jnp.asarray(gt), 0.3)["loss"])(
        jnp.asarray(pred))
    _close(p.grad, g_j, 1e-5)
    _close(tl.psnr(torch.as_tensor(pred), torch.as_tensor(gt)),
           jl.psnr(jnp.asarray(pred), jnp.asarray(gt)), 1e-6)


def test_depth_loss_and_regularizers():
    rng = np.random.default_rng(1)
    d = rng.uniform(0.5, 4.0, (2, 8, 9, 1)).astype(np.float32)
    gt = rng.uniform(0.5, 4.0, d.shape).astype(np.float32)
    gt[rng.uniform(size=gt.shape) < 0.3] = 0.0
    _close(tl.depth_loss(torch.as_tensor(d), torch.as_tensor(gt), 2.5),
           jl.depth_loss(jnp.asarray(d), jnp.asarray(gt), 2.5), 1e-6)
    params = {"opacities": rng.normal(size=50).astype(np.float32),
              "scales": rng.normal(size=(50, 3)).astype(np.float32)}
    alive = rng.uniform(size=50) < 0.7
    for o, s in ((0.0, 0.0), (0.01, 0.0), (0.02, 0.05)):
        got = tl.regularizers({k: torch.as_tensor(v) for k, v in params.items()},
                              torch.as_tensor(alive), o, s)
        want = jl.regularizers({k: jnp.asarray(v) for k, v in params.items()},
                               jnp.asarray(alive), o, s)
        _close(got, want, 1e-6)


def _tree(seed, cap=40):
    rng = np.random.default_rng(seed)
    return {
        "means": rng.normal(size=(cap, 3)).astype(np.float32),
        "quats": rng.normal(size=(cap, 4)).astype(np.float32),
        "scales": rng.normal(loc=-3, size=(cap, 3)).astype(np.float32),
        "opacities": rng.normal(size=cap).astype(np.float32),
        "sh0": rng.normal(size=(cap, 1, 3)).astype(np.float32),
        "shN": rng.normal(size=(cap, 3, 3)).astype(np.float32),
    }


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


@pytest.mark.parametrize("masked", [False, True])
def test_adam_update(masked):
    params, grads = _tree(2), _tree(3)
    rng = np.random.default_rng(4)
    vis = rng.uniform(size=40) < 0.6
    hp = topt.adam_hparams(2)
    assert hp == jopt.adam_hparams(2)
    lrs_f = topt.base_lrs(3.7)
    assert lrs_f == jopt.base_lrs(3.7)
    for step, max_steps in ((0, 100), (37, 100), (7000, 30000)):
        _close(topt.means_lr_decay(step, max_steps),
               jopt.means_lr_decay(jnp.int32(step), max_steps), 1e-6)
    lr_t = dict(lrs_f, means=lrs_f["means"] * topt.means_lr_decay(37, 100))
    lr_j = dict(lrs_f, means=lrs_f["means"] * jopt.means_lr_decay(jnp.int32(37), 100))
    st_t, st_j = topt.adam_init(_t(params)), jopt.adam_init(_j(params))
    p_t, p_j = _t(params), _j(params)
    for i in range(3):  # three steps: moments and bias correction carry over
        g = _tree(10 + i)
        kw = dict(b1=hp["b1"], b2=hp["b2"], eps=hp["eps"])
        p_t, st_t = topt.adam_update(_t(g), st_t, p_t, lr_t, **kw,
                                     visible_mask=torch.as_tensor(vis) if masked else None)
        p_j, st_j = jopt.adam_update(_j(g), st_j, p_j, lr_j, **kw,
                                     visible_mask=jnp.asarray(vis) if masked else None)
    assert int(st_t.count) == int(st_j.count) == 3
    for k in params:
        _close(p_t[k], p_j[k], 1e-6)
        _close(st_t.m[k], st_j.m[k], 1e-6)
        _close(st_t.v[k], st_j.v[k], 1e-6)
    if masked:
        np.testing.assert_array_equal(p_t["means"].numpy()[~vis], params["means"][~vis])
    touched = rng.uniform(size=40) < 0.3
    z_t = topt.surgery_zero_moments(st_t, torch.as_tensor(touched))
    z_j = jopt.surgery_zero_moments(st_j, jnp.asarray(touched))
    for k in params:
        np.testing.assert_array_equal(z_t.m[k].numpy(), np.asarray(z_j.m[k]))
        np.testing.assert_array_equal(z_t.v[k].numpy(), np.asarray(z_j.v[k]))


def test_strategy_update():
    rng = np.random.default_rng(5)
    g = rng.normal(scale=1e-3, size=(2, 30, 2)).astype(np.float32)
    radii = rng.uniform(-2, 5, (2, 30)).astype(np.float32).clip(0)
    st_t = ts.strategy_update(ts.strategy_init(30, device="cpu"), torch.as_tensor(g),
                              torch.as_tensor(radii), 64, 48)
    st_j = js.strategy_update(js.strategy_init(30), jnp.asarray(g), jnp.asarray(radii), 64, 48)
    _close(st_t.grad2d, st_j.grad2d, 1e-6)
    np.testing.assert_array_equal(st_t.count.numpy(), np.asarray(st_j.count))


def test_strategy_init_device():
    """The port's device rule: CUDA unless device="cpu", and no silent fall
    back to the CPU where there is no card."""
    st = ts.strategy_init(8, device="cpu")
    for x in st:
        assert x.device.type == "cpu" and x.shape == (8,) and not x.any()
    if torch.cuda.is_available():
        assert ts.strategy_init(8).grad2d.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ts.strategy_init(8)


def _refine_state(cap=64, n_alive=56, seed=6):
    """Duplicates, splits and prunes, and more growers than free slots."""
    rng = np.random.default_rng(seed)
    params = _tree(seed, cap)
    params["scales"][:, :] = np.log(rng.uniform(0.001, 0.05, (cap, 3))).astype(np.float32)
    params["opacities"][rng.uniform(size=cap) < 0.15] = -8.0  # prune
    alive = np.arange(cap) < n_alive
    grad2d = rng.uniform(0, 6e-4, cap).astype(np.float32)
    count = rng.integers(0, 4, cap).astype(np.float32)
    m, v = _tree(seed + 1, cap), _tree(seed + 2, cap)
    return params, alive, grad2d, count, m, v


@pytest.mark.parametrize("step,revised", [(100, False), (5000, True)])
def test_default_refine_same_draws(step, revised):
    params, alive, grad2d, count, m, v = _refine_state()
    cfg_j = js.DefaultStrategyCfg(revised_opacity=revised)
    cfg_t = ts.DefaultStrategyCfg(revised_opacity=revised)
    assert dataclasses.asdict(cfg_j) == dataclasses.asdict(cfg_t)
    key = jax.random.PRNGKey(9)
    k1, k2 = jax.random.split(key)
    cap = alive.shape[0]
    noise = (np.array(jax.random.normal(k1, (cap, 3))),
             np.array(jax.random.normal(k2, (cap, 3))))
    out_j = js.default_refine(
        key, _j(params), jopt.AdamState(_j(m), _j(v), jnp.int32(3)), jnp.asarray(alive),
        js.StrategyState(jnp.asarray(grad2d), jnp.asarray(count)), jnp.int32(step),
        cfg_j, 2.0)
    out_t = ts.default_refine(
        tuple(map(torch.as_tensor, noise)), _t(params),
        topt.AdamState(_t(m), _t(v), torch.tensor(3, dtype=torch.int32)),
        torch.as_tensor(alive), ts.StrategyState(torch.as_tensor(grad2d),
                                                 torch.as_tensor(count)),
        step, cfg_t, 2.0)
    p_j, o_j, a_j, s_j, i_j = out_j
    p_t, o_t, a_t, s_t, i_t = out_t
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    for k in i_j:
        assert int(i_t[k]) == int(i_j[k]), k
    assert int(i_t["n_granted"]) > 0 and int(i_t["n_prune"]) > 0
    assert int(i_t["n_granted"]) < int(i_t["n_dupli"]) + int(i_t["n_split"])
    for k in params:
        _close(p_t[k], p_j[k], 1e-6)
        np.testing.assert_array_equal(o_t.m[k].numpy(), np.asarray(o_j.m[k]))
        np.testing.assert_array_equal(o_t.v[k].numpy(), np.asarray(o_j.v[k]))
    assert not s_t.grad2d.any() and not s_t.count.any()

    r_t = ts.reset_opacity(p_t, o_t, a_t, 0.01)
    r_j = js.reset_opacity(p_j, o_j, a_j, 0.01)
    _close(r_t[0]["opacities"], r_j[0]["opacities"], 1e-6)
    assert not r_t[1].m["opacities"].any() and not r_t[1].v["opacities"].any()


def test_free_slot_targets():
    rng = np.random.default_rng(7)
    free = rng.uniform(size=50) < 0.3
    need = ~free & (rng.uniform(size=50) < 0.6)
    t_t, g_t = ts._free_slot_targets(torch.as_tensor(free), torch.as_tensor(need))
    t_j, g_j = js._free_slot_targets(jnp.asarray(free), jnp.asarray(need))
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_config_adjust_steps():
    fields_t = [f.name for f in dataclasses.fields(tconfig.Config)]
    assert fields_t == [f.name for f in dataclasses.fields(jconfig.Config)]
    for f, strat in ((1.0, "default"), (0.25, "default"), (0.5, "mcmc")):
        sj = js.DefaultStrategyCfg() if strat == "default" else js.MCMCStrategyCfg()
        st = ts.DefaultStrategyCfg() if strat == "default" else ts.MCMCStrategyCfg()
        cj = jconfig.Config(steps_scaler=f, strategy=sj).adjust_steps()
        ct = tconfig.Config(steps_scaler=f, strategy=st).adjust_steps()
        dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
        assert dt == dj


def test_n_alive_and_grow_capacity():
    params, alive = tg.init_splats_random(24, 20, 1.5, sh_degree=1, seed=3, device="cpu")
    pj, aj = jg.init_splats_random(24, 20, 1.5, sh_degree=1, seed=3)
    assert int(tg.n_alive(alive)) == int(jg.n_alive(aj)) == 20
    gt, at = tg.grow_capacity(params, alive, 40)
    gj, aj2 = jg.grow_capacity(pj, aj, 40)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj2))
    for k in gj:
        assert gt[k].shape == gj[k].shape
        np.testing.assert_allclose(gt[k].numpy(), np.asarray(gj[k]), rtol=1e-6)
    same, a_same = tg.grow_capacity(params, alive, 24)
    assert same is params and a_same is alive


def test_init_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.init_splats_random(8, 4, 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tg.init_splats_from_points(np.zeros((4, 3)), np.zeros((4, 3)), 8)
