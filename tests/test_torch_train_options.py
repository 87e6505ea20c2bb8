"""Port parity: the Trainer's options against the JAX package.

- ``pose_opt.apply_pose_adjust``, ``bilateral_grid`` (``slice_grid``,
  ``total_variation_loss``, the CP-4D grid, ``color_correct``) and
  ``appearance.appearance_color`` on the same inputs: values within 1e-6
  rel (of each output's max) and gradients within 1e-5 rel;
  ``color_correct``, an f32 least-squares solve, within 5e-5.
- ``mcmc_refine`` and ``mcmc_noise`` fed the JAX package's own draws
  (its ``jax.random.categorical`` targets and normal draws at a small
  capacity): outputs within 1e-6 of each output's max.
- ``mcmc_draw_targets`` follows p = max(opacity, 1e-8) over the live
  gaussians (a chi-square bound on a histogram).
- For each option set, a port Trainer resumes from a JAX Trainer's
  checkpoint taken with that option and both take steps on one small
  scene: losses within 1e-3 rel (the bar of tests/test_torch_trainer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from splat_one_tpu.train import appearance as japp
from splat_one_tpu.train import bilateral_grid as jbg
from splat_one_tpu.train import pose_opt as jpose
from splat_one_tpu.train import strategy as jS
from splat_one_tpu.train.config import Config as JConfig
from splat_one_tpu.train.optimizers import adam_init as jadam_init
from splat_one_tpu.train.trainer import SceneData as JSceneData
from splat_one_tpu.train.trainer import Trainer as JTrainer
from splat_one_tpu_torch.data.depth_supervision import sparse_depth_map
from splat_one_tpu_torch.data.synthetic import make_synthetic_scene
from splat_one_tpu_torch.train import appearance as app
from splat_one_tpu_torch.train import bilateral_grid as bg
from splat_one_tpu_torch.train import pose_opt
from splat_one_tpu_torch.train import strategy as S
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.optimizers import adam_init
from splat_one_tpu_torch.train.trainer import SceneData, Trainer

VAL_RTOL, GRAD_RTOL, MCMC_RTOL, LOSS_RTOL = 1e-6, 1e-5, 1e-6, 1e-3
CC_ATOL = 5e-5  # color_correct: an f32 least-squares solve (see below)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-30)


def _check(fn_t, fn_j, inputs, weights_seed=1):
    """fn_t / fn_j on the same numpy inputs: value and the gradient of a
    seeded weighted sum with respect to every input."""
    t_in = [torch.tensor(x, requires_grad=True) for x in inputs]
    out_t = fn_t(*t_in)
    w = np.random.default_rng(weights_seed).normal(size=out_t.shape).astype(np.float32)
    grads_t = torch.autograd.grad((out_t * torch.tensor(w)).sum(), t_in)
    out_j, vjp = jax.vjp(fn_j, *[jnp.asarray(x) for x in inputs])
    grads_j = vjp(jnp.asarray(w))
    assert out_t.shape == out_j.shape
    assert _rel(out_t.detach().numpy(), out_j) <= VAL_RTOL
    for i, (gt, gj) in enumerate(zip(grads_t, grads_j)):
        assert _rel(gt.numpy(), gj) <= GRAD_RTOL, f"input {i}"


def test_pose_adjust_matches_jax():
    rng = np.random.default_rng(0)
    c2w = np.tile(np.eye(4, dtype=np.float32), (3, 1, 1))
    c2w[:, :3, 3] = rng.normal(size=(3, 3))
    emb = (rng.normal(size=(3, 9)) * 0.1).astype(np.float32)
    _check(pose_opt.apply_pose_adjust, jpose.apply_pose_adjust, [c2w, emb])
    noise = rng.normal(size=(3, 9)).astype(np.float32)
    np.testing.assert_allclose(
        pose_opt.perturb_poses(torch.tensor(noise), torch.tensor(c2w), 0.01).numpy(),
        np.asarray(jpose.apply_pose_adjust(jnp.asarray(c2w), jnp.asarray(noise) * 0.01)),
        rtol=0, atol=1e-6)
    assert torch.equal(pose_opt.init_pose_params(5), torch.zeros(5, 9))


def test_bilateral_grid_matches_jax():
    rng = np.random.default_rng(1)
    grids = np.asarray(jbg.init_bilateral_grids(2, (8, 6, 4)))
    np.testing.assert_array_equal(bg.init_bilateral_grids(2, (8, 6, 4)).numpy(), grids)
    grids = (grids + rng.normal(size=grids.shape) * 0.05).astype(np.float32)
    rgb = rng.uniform(size=(2, 20, 24, 3)).astype(np.float32)
    _check(bg.slice_grid, jbg.slice_grid, [grids, rgb])
    _check(lambda g: bg.total_variation_loss(g)[None],
           lambda g: jbg.total_variation_loss(g)[None], [grids])

    # CP-4D: the same factors fed to both
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    p_np = {"mix": mk(5, 12) * 0.1 + np.eye(5, 12, dtype=np.float32), "fx": mk(5, 16),
            "fy": mk(5, 16), "fz": mk(5, 16), "fw": mk(5, 8),
            "bound": np.float32(2.0),
            "gray_mlp": [{"w": mk(3, 8), "b": mk(8)}, {"w": mk(8, 1), "b": mk(1)}]}
    to_t = lambda p: {k: ([{kk: torch.tensor(vv) for kk, vv in l.items()} for l in v]
                          if k == "gray_mlp" else torch.tensor(v)) for k, v in p.items()}
    to_j = lambda p: jax.tree.map(jnp.asarray, p)
    xyz = (rng.uniform(size=(300, 3)) * 3 - 1.5).astype(np.float32)
    col = rng.uniform(size=(300, 3)).astype(np.float32)
    for gray in (True, False):
        pn = dict(p_np) if gray else {k: v for k, v in p_np.items() if k != "gray_mlp"}
        _check(lambda x, c: bg.apply_cp4d(to_t(pn), x, c),
               lambda x, c: jbg.apply_cp4d(to_j(pn), x, c), [xyz, col])
        _check(lambda f: bg.slice_cp4d({**to_t(pn), "fx": f}, torch.tensor(xyz),
                                       torch.tensor(col)),
               lambda f: jbg.slice_cp4d({**to_j(pn), "fx": f}, jnp.asarray(xyz),
                                        jnp.asarray(col)), [p_np["fx"]])
    _check(lambda f: bg.total_variation_loss_cp4d({**to_t(p_np), "fw": f})[None],
           lambda f: jbg.total_variation_loss_cp4d({**to_j(p_np), "fw": f})[None],
           [p_np["fw"]])
    p = bg.init_cp4d(torch.Generator().manual_seed(0))
    assert p["mix"].shape == (5, 12) and len(p["gray_mlp"]) == 2
    ident = bg.apply_cp4d(p, torch.tensor(xyz), torch.tensor(col))
    assert float((ident - torch.tensor(col)).abs().max()) < 1e-4

    # colour correction: an affine colour shift is undone by the fit. Its
    # 10x10 normal equations in f32 have a condition number near 1.3e3, so
    # two f32 Gram matmuls that sum in other orders give solutions apart
    # by up to cond * 2^-23 ~ 1.6e-4; the bar is CC_ATOL, and each package
    # stays as close to the float64 solve.
    pred = rng.uniform(size=(16, 20, 3)).astype(np.float32)
    gt = np.clip(pred * 0.8 + 0.1 + 0.02 * pred[..., ::-1], 0, 1).astype(np.float32)
    cc_t = bg.color_correct(torch.tensor(pred), torch.tensor(gt)).numpy()
    cc_j = np.asarray(jbg.color_correct(jnp.asarray(pred), jnp.asarray(gt)))
    cc_64 = bg.color_correct(torch.tensor(pred, dtype=torch.float64),
                             torch.tensor(gt, dtype=torch.float64)).numpy()
    assert np.abs(cc_t - cc_j).max() <= CC_ATOL
    assert max(np.abs(cc_t - cc_64).max(), np.abs(cc_j - cc_64).max()) <= CC_ATOL
    assert np.abs(cc_t - gt).max() < 1e-3


def test_appearance_matches_jax():
    rng = np.random.default_rng(2)
    jp = japp.init_appearance_params(jax.random.PRNGKey(0), 4, feature_dim=8,
                                     embed_dim=6, sh_degree=2)
    p_np = {k: np.asarray(v) + (rng.normal(size=v.shape) * 0.1).astype(np.float32)
            for k, v in jp.items()}
    feats = rng.uniform(size=(50, 8)).astype(np.float32)
    dirs = rng.normal(size=(2, 50, 3)).astype(np.float32)
    ids = np.array([3, 1])
    keys = sorted(p_np)

    def f_t(features, d, *w):
        return app.appearance_color(dict(zip(keys, w)), features, torch.tensor(ids), d, 2)

    def f_j(features, d, *w):
        return japp.appearance_color(dict(zip(keys, w)), features, jnp.asarray(ids), d, 2)

    _check(f_t, f_j, [feats, dirs] + [p_np[k] for k in keys])
    pt = app.init_appearance_params(torch.Generator().manual_seed(0), 4, feature_dim=8,
                                    embed_dim=6, sh_degree=2)
    assert {k: tuple(v.shape) for k, v in pt.items()} == {k: v.shape for k, v in jp.items()}


def _mcmc_state(cap=256, seed=3):
    rng = np.random.default_rng(seed)
    n = cap * 3 // 4
    alive = np.arange(cap) < n
    opa = rng.uniform(0.0005, 0.5, size=cap)
    opa[rng.choice(n, size=n // 5, replace=False)] = 0.002  # dead
    q = rng.normal(size=(cap, 4))
    params = {"means": rng.normal(size=(cap, 3)), "quats": q,
              "scales": rng.normal(size=(cap, 3)) - 3,
              "opacities": np.log(opa / (1 - opa)),
              "sh0": rng.normal(size=(cap, 1, 3)), "shN": rng.normal(size=(cap, 3, 3))}
    return {k: v.astype(np.float32) for k, v in params.items()}, alive


def test_mcmc_refine_and_noise_on_jax_draws():
    cap = 256
    p_np, alive_np = _mcmc_state(cap)
    cfg_j = jS.MCMCStrategyCfg(cap_max=300)
    cfg_t = S.MCMCStrategyCfg(cap_max=300)
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    pt = {k: torch.tensor(v) for k, v in p_np.items()}
    # the Adam moments hold ones, so the zeroed slots show
    sj = jadam_init(pj)
    sj = sj._replace(m=jax.tree.map(jnp.ones_like, sj.m), v=jax.tree.map(jnp.ones_like, sj.v))
    st = adam_init(pt)
    st = st._replace(m={k: torch.ones_like(v) for k, v in st.m.items()},
                     v={k: torch.ones_like(v) for k, v in st.v.items()})

    # JAX's own targets, drawn as mcmc_refine draws them
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    opa = jax.nn.sigmoid(pj["opacities"])
    live = jnp.asarray(alive_np) & ~(opa < cfg_j.min_opacity)
    logits = jnp.where(live, jnp.log(jnp.maximum(opa, 1e-8)), -jnp.inf)
    tgt = np.asarray(jax.random.categorical(k1, logits, shape=(cap,)))
    tgt2 = np.asarray(jax.random.categorical(k2, logits, shape=(cap,)))

    out_j = jS.mcmc_refine(key, pj, sj, jnp.asarray(alive_np), cfg_j)
    out_t = S.mcmc_refine(torch.tensor(tgt), torch.tensor(tgt2), pt, st,
                          torch.tensor(alive_np), cfg_t)
    for k in p_np:
        assert _rel(out_t[0][k].numpy(), out_j[0][k]) <= MCMC_RTOL, k
    for k in p_np:
        np.testing.assert_array_equal(out_t[1].m[k].numpy(), np.asarray(out_j[1].m[k]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    info_j = {k: int(v) for k, v in out_j[3].items()}
    assert {k: int(v) for k, v in out_t[3].items()} == info_j
    assert info_j["n_relocated"] > 0 and info_j["n_grown"] > 0

    # noise: JAX's normal draws, scaled and shaped by the covariance
    p_np["opacities"][:64] = -6.0  # opacity 0.0025: the gate is open
    pj = {k: jnp.asarray(v) for k, v in p_np.items()}
    eps = np.asarray(jax.random.normal(key, (cap, 3)))
    nj = jS.mcmc_noise(key, pj, jnp.asarray(alive_np), jnp.asarray(1.6e-4), 5e5)
    nt = S.mcmc_noise(torch.tensor(eps), {k: torch.tensor(v) for k, v in p_np.items()},
                      torch.tensor(alive_np), torch.tensor(1.6e-4), 5e5)
    assert _rel(nt["means"].numpy(), nj["means"]) <= MCMC_RTOL
    assert np.abs(np.asarray(nj["means"]) - p_np["means"]).max() > 1e-4


def test_mcmc_targets_follow_opacity():
    """Draws of mcmc_draw_targets against p: a chi-square bound on the
    histogram of 20 x cap draws; dead and free slots are never drawn."""
    cap = 256
    p_np, alive_np = _mcmc_state(cap, seed=5)
    params = {k: torch.tensor(v) for k, v in p_np.items()}
    alive = torch.tensor(alive_np)
    cfg = S.MCMCStrategyCfg()
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros(cap)
    for _ in range(10):
        for t in S.mcmc_draw_targets(params, alive, cfg, gen):
            assert t.shape == (cap,)
            counts += np.bincount(t.numpy(), minlength=cap)
    opa = 1 / (1 + np.exp(-p_np["opacities"].astype(np.float64)))
    live = alive_np & (opa >= cfg.min_opacity)
    p = np.where(live, opa, 0.0)
    p /= p.sum()
    assert counts[~live].sum() == 0
    expect = p[live] * counts.sum()
    chi2 = ((counts[live] - expect) ** 2 / expect).sum()
    dof = live.sum() - 1
    assert chi2 < dof + 5 * np.sqrt(2 * dof), (chi2, dof)
    # no live gaussian: every draw is slot 0, as JAX's arg-max of -inf logits
    none = {**params, "opacities": torch.full((cap,), -10.0)}
    for t in S.mcmc_draw_targets(none, alive, cfg, gen):
        assert int(t.abs().max()) == 0


@pytest.fixture(scope="module")
def scene():
    s, _ = make_synthetic_scene(n_gaussians=400, n_cameras=6, width=64, height=64,
                                n_points=200, device="cpu")
    depths = np.stack([sparse_depth_map(s.points, s.camtoworlds[i], s.Ks[i], 64, 64)
                       for i in range(len(s.camtoworlds))])
    return s._replace(depths=depths)


OFF = dict(refine_start_iter=10_000, refine_stop_iter=10_001, refine_every=10_000)
BASE = dict(max_steps=3, eval_steps=[], save_steps=[], sh_degree=1, sh_degree_interval=2,
            capacity=512, camera_model="pinhole", test_every=6, batch_size=1)
OPTIONS = {
    "pose": dict(pose_opt=True, pose_opt_lr=1e-3),
    "bilateral_grid": dict(use_bilateral_grid=True),
    "depth": dict(depth_loss=True),
    "appearance": dict(app_opt=True),
    "mcmc": "mcmc",
}


def _stop_after(n):
    calls = {"n": 0}

    def stop():
        calls["n"] += 1
        return calls["n"] > n

    return stop


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_trainer_option_resumes_jax_checkpoint(option, scene, tmp_path):
    from splat_one_tpu.train.strategy import DefaultStrategyCfg as JDefault
    from splat_one_tpu.train.strategy import MCMCStrategyCfg as JMCMC

    kw = OPTIONS[option]
    if kw == "mcmc":
        mk = dict(cap_max=400, **OFF)
        cfg_j = JConfig(result_dir=str(tmp_path / "j"), strategy=JMCMC(**mk), **BASE)
        cfg_t = Config(result_dir=str(tmp_path / "t"), strategy=S.MCMCStrategyCfg(**mk),
                       **BASE)
    else:
        off = dict(reset_every=10_000, **OFF)
        cfg_j = JConfig(result_dir=str(tmp_path / "j"), strategy=JDefault(**off), **BASE, **kw)
        cfg_t = Config(result_dir=str(tmp_path / "t"), strategy=S.DefaultStrategyCfg(**off),
                       **BASE, **kw)
    jt = JTrainer(cfg_j, JSceneData(*scene))
    h_j = jt.train(log_every=1, stop_flag=_stop_after(1))
    ckpt = jt.save_checkpoint(1)
    tt = Trainer(cfg_t, SceneData(*scene), device="cpu")
    assert tt.capacity == jt.capacity
    tt.load_checkpoint(ckpt)
    st = tt.state
    for name, want in (("pose_params", jt.state.pose_params), ("bil_grids", jt.state.bil_grids)):
        got = getattr(st, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if jt.state.app_params is not None:
        for k, v in jt.state.app_params.items():
            np.testing.assert_array_equal(st.app_params[k].numpy(), np.asarray(v))
            np.testing.assert_array_equal(st.app_opt_state.m[k].numpy(),
                                          np.asarray(jt.state.app_opt_state.m[k]))
    h_j += jt.train(log_every=1)
    h_t = tt.train(log_every=1)
    l_j = np.array([h["loss"] for h in h_j])
    assert len(h_t) == len(l_j) - 1 and np.isfinite(l_j).all()
    np.testing.assert_allclose([h["loss"] for h in h_t], l_j[1:], rtol=LOSS_RTOL)
    if kw != "mcmc" and kw.get("depth_loss"):
        np.testing.assert_allclose([h["depthloss"] for h in h_t],
                                   [h["depthloss"] for h in h_j[1:]], rtol=LOSS_RTOL)
    # the options' own parameters (the poses through the view matrices)
    # moved from the checkpoint's as JAX's did
    for name in ("pose_params", "bil_grids", "app_params"):
        got, want, was = getattr(tt.state, name), getattr(jt.state, name), getattr(st, name)
        if want is None:
            continue
        if name == "app_params":
            got, want, was = got["embeds"], want["embeds"], was["embeds"]
        step = np.abs(np.asarray(want) - was.numpy()).max()
        assert step > 0 and np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4 * step, name
    # the port's own checkpoint of the option's state loads back equal
    path = tt.save_checkpoint(tt.state.step)
    tr = Trainer(cfg_t, SceneData(*scene), device="cpu")
    tr.load_checkpoint(path)
    for a, b in zip(_leaves(tr.state), _leaves(tt.state)):
        np.testing.assert_array_equal(a, b)


def _leaves(state):
    out = []
    for x in state:
        if isinstance(x, torch.Tensor):
            out.append(x.numpy())
        elif isinstance(x, dict):
            out += [x[k].numpy() for k in sorted(x)]
        elif isinstance(x, tuple):
            out += _leaves(x)
        elif x is not None:
            out.append(np.asarray(x))
    return out


def test_trainer_mcmc_rules(scene, tmp_path):
    """MCMC sizes the capacity for cap_max, relocates and grows at each
    refine, keeps its capacity past 0.9 full (the default strategy would
    double it) and takes no opacity reset."""
    kw = dict(max_steps=4, eval_steps=[], save_steps=[], sh_degree=1,
              camera_model="pinhole", test_every=6)
    big = Trainer(Config(result_dir=str(tmp_path / "b"),
                         strategy=S.MCMCStrategyCfg(cap_max=3000), **kw),
                  SceneData(*scene), device="cpu")
    assert big.capacity == 4096  # 200 points alone would give 1024
    # 120 points in 128 slots: past 0.9 full from the first refine
    few = SceneData(*scene)._replace(points=scene.points[:120],
                                     points_rgb=scene.points_rgb[:120])
    mc = S.MCMCStrategyCfg(cap_max=128, refine_start_iter=0, refine_stop_iter=100,
                           refine_every=2)
    tr = Trainer(Config(result_dir=str(tmp_path / "m"), capacity=128, strategy=mc, **kw), few,
                 device="cpu")
    assert tr.capacity == 128
    hist = tr.train(log_every=1)
    assert np.isfinite([h["loss"] for h in hist]).all()
    refines = [h for h in hist if "n_grown" in h]
    assert [h["step"] for h in refines] == [2, 4]
    assert [h["n_grown"] for h in refines] == [6, 2] and hist[-1]["num_GS"] == 128
    assert tr.capacity == 128 and tr.state.alive.shape[0] == 128
    # no reset: alive opacities were never clamped to 2 * prune_opa
    limit = float(np.log(0.01 / 0.99))
    assert float(tr.state.params["opacities"][tr.state.alive].max()) > limit + 1
