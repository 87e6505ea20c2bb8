"""Port parity: the multi-GPU path, in spawned gloo worlds on the CPU.

Each world is ``WORLD`` spawned processes, one thread each, meeting
through a file in the test's tmp_path (no ports, so xdist workers cannot
clash), each through the port's entry points (``multihost.initialize``,
``global_mesh``). Every world has two limits: ``init_process_group``
times out after ``INIT_TIMEOUT_S`` and the parent kills the processes
and fails at ``DEADLINE_S``, so a hang fails fast. The children never
import JAX: the JAX references are computed here, in the test process
(the conftest's 8-device CPU mesh), once per module.

- ``rasterization_ring_sharded`` and ``rasterization_tile_sharded`` in a
  world of 4, on a pinhole grid of 18 (camera, supertile) cells (2
  phantom cells) and a spherical one of 10 (2 phantom), against JAX's
  functions of the same name on a 4-device mesh at JAX's bars (loss 1e-5
  rel, gradients 5e-4 of each one's max); the ring-sharded module gives
  what the Trainer's call (``rasterization`` with ``proj_transform=
  gather_gauss`` and ``st_shard``) gives, and the tile-sharded gradients
  are whole on every rank.
- The mesh Trainer at 2 data x 2 gauss against the port's single-device
  Trainer from the same anisotropic checkpoint, with a refine inside the
  steps: the first loss within 1e-5 rel, the first step's gradients (the
  Adam moments after it, m = (1 - b1) g) within 5e-4 of each one's max
  (an n_gauss-fold gradient fails this), the refine's counts equal, the
  losses within JAX's bar (rtol 2e-2, atol 2e-3,
  ``tests/test_trainer.py:290``); its gathered checkpoint has the
  single-device keys and shapes and loads in the viewer, its sharded one
  round-trips equal and refuses another mesh shape.
  The eval at the last step gives the single-device PSNR within 0.01 dB.
- ``pose_opt`` + ``use_bilateral_grid`` + ``app_opt`` at 2 x 2: the
  replicated modules equal on every rank and within 1e-2 of the
  single-device run (JAX's bar, ``tests/test_trainer.py:327-330``), and
  their first step's gradients (the Adam moments after it) within 5e-4
  of each one's max: Adam's update hides a gradient's scale, the moments
  do not.
- Capacity growth and the MCMC strategy at 2 x 2: every rank's history
  and capacity alike, the growth where the single-device Trainer's is.
"""

import json
import os
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

WORLD = 4
INIT_TIMEOUT_S = 60
DEADLINE_S = 240
W_P, H_P, C_P = 96, 80, 2  # 3 x 3 supertiles a camera: 18 cells over 4 ranks
W_S, H_S = 160, 64  # 5 x 2 supertiles: 10 cells over 4 ranks


# ------------------------------------------------------------ the worlds
def _entry(fn, rank, world, init_file, args):
    torch.set_num_threads(1)
    from splat_one_tpu_torch.parallel import multihost

    multihost.initialize(rank, world, device="cpu", init_method=f"file://{init_file}",
                         timeout_s=INIT_TIMEOUT_S)
    try:
        fn(rank, *args)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _run_world(fn, tmp_path, *args):
    """Run ``fn(rank, *args)`` in a spawned world of ``WORLD`` processes;
    fail, with every process killed, if one fails or the world outlives
    ``DEADLINE_S``."""
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(fn, r, WORLD, str(tmp_path / "pg"), args))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
        p.join(10)
    assert not hung, f"world hung past {DEADLINE_S} s: killed {hung}"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


# ------------------------------------------------------------ the scenes
def _scene(spherical):
    """tests/test_ring_sharded.py's scenes, cut to grids that 4 ranks do
    not divide."""
    n, c, w, h = (512, 1, W_S, H_S) if spherical else (512, C_P, W_P, H_P)
    rng = np.random.default_rng(7 if spherical else 0)
    means = rng.normal(scale=2.0 if spherical else 1.0, size=(n, 3)).astype(np.float32)
    if not spherical:
        means[:, 2] += 3
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    scales = np.exp(rng.normal(-2.2 if spherical else -2.8, 0.4, (n, 3))).astype(np.float32)
    opac = (1 / (1 + np.exp(-rng.normal(size=n)))).astype(np.float32)
    sh = (rng.normal(size=(n, 4, 3)) * 0.3).astype(np.float32)
    c2w = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    if c > 1:
        c2w[1, 0, 3] = 0.2
    vm = np.linalg.inv(c2w).astype(np.float32)
    f = w / (2 * np.pi) if spherical else 60.0
    Ks = np.tile(np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32), (c, 1, 1))
    return [means, quats, scales, opac, sh, vm, Ks], w, h


def _weights(n):
    return np.linspace(0.5, 1.5, n, dtype=np.float32)


def _raster_world(rank, out_dir):
    """Each rank: the ring-sharded module, the Trainer's sharded call of
    ``rasterization`` and the tile-sharded render of both scenes, with
    losses and gradients."""
    from splat_one_tpu_torch.parallel import comm
    from splat_one_tpu_torch.parallel.ring_sharded import rasterization_ring_sharded
    from splat_one_tpu_torch.parallel.tile_sharded import rasterization_tile_sharded
    from splat_one_tpu_torch.render.rasterization import rasterization

    res = {}
    for spherical in (False, True):
        model = "spherical" if spherical else "pinhole"
        args, w, h = _scene(spherical)
        t = [torch.as_tensor(x) for x in args]
        nl = t[0].shape[0] // WORLD

        def loss_of(rgb, a, d):
            wts = torch.as_tensor(_weights(rgb.numel())).reshape(rgb.shape)
            return (rgb * wts).sum() + 0.3 * a.sum() + d.sum()

        shard = [x[rank * nl:(rank + 1) * nl].clone().requires_grad_(True) for x in t[:5]]
        loss = loss_of(*rasterization_ring_sharded(*shard, t[5], t[6], w, h, None,
                                                   sh_degree=1, camera_model=model))
        res[f"{model}_ring"] = [float(loss.detach())] + [g.numpy() for g in
                                                torch.autograd.grad(loss, shard)]
        shard = [x[rank * nl:(rank + 1) * nl].clone().requires_grad_(True) for x in t[:5]]
        render, alpha, _ = rasterization(
            *shard, t[5], t[6], w, h, sh_degree=1, camera_model=model, render_mode="RGB+ED",
            proj_transform=lambda p: comm.gather_gauss(p, None),
            st_shard=(None, WORLD))
        loss = loss_of(render[..., :3], alpha, render[..., 3:])
        res[f"{model}_gather"] = [float(loss.detach())] + [g.numpy() for g in
                                                  torch.autograd.grad(loss, shard)]
        full = [x.clone().requires_grad_(True) for x in t[:5]]
        loss = loss_of(*rasterization_tile_sharded(*full, t[5], t[6], w, h, None,
                                                   sh_degree=1, camera_model=model))
        res[f"{model}_tile"] = [float(loss.detach())] + [g.numpy() for g in
                                                torch.autograd.grad(loss, full)]
    # the mesh's refusals: a world of another size, a CUDA mesh without NCCL
    from splat_one_tpu_torch.parallel.train_step import make_mesh

    refused = []
    for args, err in (((2, 4, "cpu"), ValueError), ((1, 4, "cuda"), RuntimeError)):
        try:
            make_mesh(*args)
        except err as e:
            refused.append(str(e))
    res["refused"] = [len(refused)]
    np.savez(os.path.join(out_dir, f"raster_{rank}.npz"),
             **{f"{k}_{i}": np.asarray(v) for k, vals in res.items()
                for i, v in enumerate(vals)})


@pytest.fixture(scope="module")
def jax_sharded():
    """JAX's ring-sharded render of the pinhole scene and tile-sharded render
    of the spherical one on a 4-device mesh: (loss, gradients)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from splat_one_tpu.parallel.ring_sharded import rasterization_ring_sharded
    from splat_one_tpu.parallel.tile_sharded import rasterization_tile_sharded

    out = {}
    for spherical, fn, axis in ((False, rasterization_ring_sharded, "shard"),
                                (True, rasterization_tile_sharded, "tiles")):
        args, w, h = _scene(spherical)
        a = [jnp.asarray(x) for x in args]
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]), (axis,))

        def loss(*p):
            rgb, al, d = fn(*p, a[5], a[6], w, h, mesh, sh_degree=1,
                            camera_model="spherical" if spherical else "pinhole")
            wts = jnp.asarray(_weights(rgb.size)).reshape(rgb.shape)
            return jnp.sum(rgb * wts) + 0.3 * jnp.sum(al) + jnp.sum(d)

        l, g = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4)))(*a[:5])
        out["spherical" if spherical else "pinhole"] = (
            float(l), [np.asarray(x) for x in g])
    return out


@pytest.fixture(scope="module")
def raster_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("raster_world")
    t0 = time.perf_counter()
    _run_world(_raster_world, tmp, str(tmp))
    res = [np.load(tmp / f"raster_{r}.npz") for r in range(WORLD)]
    return res, time.perf_counter() - t0


def _assert_grads_close(got, want, bar, what):
    for i, (a, b) in enumerate(zip(got, want)):
        rel = np.abs(a - b).max() / (np.abs(b).max() + 1e-8)
        assert rel < bar, f"{what}: gradient {i} rel {rel:.3e}"


def _ring_grads(res, model, kind):
    return [np.concatenate([r[f"{model}_{kind}_{i}"] for r in res]) for i in range(1, 6)]


@pytest.mark.parametrize("model", ["pinhole", "spherical"])
def test_sharded_rasterizers_match_jax(model, raster_world, jax_sharded):
    """The port's ring- and tile-sharded renders against JAX's on the same
    scene (JAX's ring on the pinhole grid, its tile-sharded function on
    the spherical one): loss 1e-5 rel, gradients 5e-4 of max."""
    res, _ = raster_world
    loss_j, grads_j = jax_sharded[model]
    for kind in ("ring", "tile"):
        for r in res:
            np.testing.assert_allclose(float(r[f"{model}_{kind}_0"]), loss_j, rtol=1e-5)
    _assert_grads_close(_ring_grads(res, model, "ring"), grads_j, 5e-4, f"{model} ring")
    tile = [res[0][f"{model}_tile_{i}"] for i in range(1, 6)]
    for r in res[1:]:  # whole, the same on every rank
        for i, g in enumerate(tile, 1):
            np.testing.assert_array_equal(r[f"{model}_tile_{i}"], g)
    _assert_grads_close(tile, grads_j, 5e-4, f"{model} tile")


@pytest.mark.parametrize("model", ["pinhole", "spherical"])
def test_ring_equals_all_gather(model, raster_world):
    """``rasterization_ring_sharded`` gives the image of the Trainer's call
    (``rasterization`` with the all_gather exchange as ``proj_transform``
    and ``st_shard``) and, but for the order of the backward's sums, its
    gradients."""
    res, _ = raster_world
    for r in res:
        assert float(r[f"{model}_ring_0"]) == float(r[f"{model}_gather_0"])
    _assert_grads_close(_ring_grads(res, model, "ring"), _ring_grads(res, model, "gather"),
                        1e-6, f"{model} ring vs all_gather")


def test_mesh_refusals(raster_world, monkeypatch):
    """A mesh needs a world of its size and the device's backend (checked
    in the world); without a launcher's environment ``initialize`` is a
    no-op, and a mesh then needs a process group."""
    from splat_one_tpu_torch.parallel import multihost

    res, _ = raster_world
    assert all(int(r["refused_0"]) == 2 for r in res)
    for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(device="cpu")
    assert multihost.process_count() == 1 and multihost.is_primary()
    with pytest.raises(RuntimeError, match="process group"):
        multihost.global_mesh(1, 1, device="cpu")


# ------------------------------------------------------------ the Trainer
def _train_cfg(result_dir, **kw):
    from splat_one_tpu_torch.train.config import Config
    from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg

    base = dict(result_dir=result_dir, camera_model="pinhole", sh_degree=1, batch_size=2,
                capacity=4096, init_type="random", init_num_pts=300, max_steps=5,
                eval_steps=[5], save_steps=[1, 5], tb_every=1000, test_every=8,
                strategy=DefaultStrategyCfg(refine_start_iter=2, refine_stop_iter=100,
                                            refine_every=3, reset_every=10_000,
                                            grow_grad2d=2e-4))
    base.update(kw)
    return Config(**base)


OPTIONS = dict(pose_opt=True, pose_opt_lr=1e-3, use_bilateral_grid=True, app_opt=True,
               max_steps=4, save_steps=[1], eval_steps=[])
# 300 gaussians in 320 rows: the refine fills them and the capacity doubles
GROW = dict(capacity=320, max_steps=4, save_steps=[], eval_steps=[])


def _mcmc():
    from splat_one_tpu_torch.train.strategy import MCMCStrategyCfg

    return dict(capacity=1024, max_steps=4, save_steps=[], eval_steps=[],
                strategy=MCMCStrategyCfg(cap_max=600, refine_start_iter=1, refine_every=2))


def _train_scene():
    from splat_one_tpu_torch.data.synthetic import make_synthetic_scene

    return make_synthetic_scene(n_gaussians=300, n_cameras=8, width=48, height=48,
                                device="cpu")[0]


def _replicated(state):
    out = {"pose": state.pose_params, "bil": state.bil_grids}
    out.update({f"app_{k}": v for k, v in state.app_params.items()})
    return {k: v.numpy() for k, v in out.items()}


def _trainer_world(rank, out_dir, init_ckpt):
    from splat_one_tpu_torch.parallel import multihost
    from splat_one_tpu_torch.train.trainer import Trainer

    mesh = multihost.global_mesh(2, 2, device="cpu")
    scene = _train_scene()
    tr = Trainer(_train_cfg(os.path.join(out_dir, "mesh")), scene, mesh=mesh, device="cpu")
    tr.load_checkpoint(init_ckpt)
    hist = tr.train(log_every=1)
    if multihost.is_primary():
        with open(os.path.join(out_dir, "hist.json"), "w") as f:
            json.dump(hist, f)
    path = tr.save_checkpoint_sharded(5)
    back = Trainer(_train_cfg(os.path.join(out_dir, "back")), scene, mesh=mesh, device="cpu")
    back.load_checkpoint_sharded(path)
    flat_a, flat_b = tr._flat_state(lambda x: x), back._flat_state(lambda x: x)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        np.testing.assert_array_equal(flat_a[k], flat_b[k], err_msg=k)
    assert back.capacity == tr.capacity
    opts = Trainer(_train_cfg(os.path.join(out_dir, "opts"), **OPTIONS), scene, mesh=mesh,
                   device="cpu")
    opts.train(log_every=1)
    np.savez(os.path.join(out_dir, f"replicated_{rank}.npz"), **_replicated(opts.state))
    # capacity growth and MCMC: every rank takes the same decisions
    runs = {}
    for name, kw in (("grow", GROW), ("mcmc", _mcmc())):
        tr = Trainer(_train_cfg(os.path.join(out_dir, name), **kw), scene, mesh=mesh,
                     device="cpu")
        runs[name] = {"hist": tr.train(log_every=1), "capacity": tr.capacity,
                      "rows": int(tr.state.alive.shape[0])}
    with open(os.path.join(out_dir, f"runs_{rank}.json"), "w") as f:
        json.dump(runs, f)


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    """The single-device runs here, the same runs at 2 x 2 in a world."""
    from splat_one_tpu_torch.train.trainer import Trainer

    tmp = tmp_path_factory.mktemp("trainer_world")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = _train_scene()
        single = Trainer(_train_cfg(str(tmp / "single")), scene, device="cpu")
        # anisotropic scales, so that every parameter has a first-step
        # gradient (isotropic ones give the quaternions rounding noise)
        rng = np.random.default_rng(0)
        scales = single.state.params["scales"]
        single.state.params["scales"] = scales + torch.as_tensor(
            rng.normal(0.0, 0.4, tuple(scales.shape)).astype(np.float32))
        init = single.save_checkpoint(0)
        hist = single.train(log_every=1)
        opts = Trainer(_train_cfg(str(tmp / "single_opts"), **OPTIONS), scene, device="cpu")
        opts.train(log_every=1)
        runs = {}
        for name, kw in (("grow", GROW), ("mcmc", _mcmc())):
            tr = Trainer(_train_cfg(str(tmp / f"single_{name}"), **kw), scene, device="cpu")
            runs[name] = {"hist": tr.train(log_every=1), "capacity": tr.capacity}
    finally:
        torch.set_num_threads(threads)
    t0 = time.perf_counter()
    _run_world(_trainer_world, tmp, str(tmp), init)
    with open(tmp / "hist.json") as f:
        hist_mesh = json.load(f)
    reps = [dict(np.load(tmp / f"replicated_{r}.npz")) for r in range(WORLD)]
    runs_mesh = []
    for r in range(WORLD):
        with open(tmp / f"runs_{r}.json") as f:
            runs_mesh.append(json.load(f))
    return dict(tmp=tmp, hist=hist, hist_mesh=hist_mesh, single=single,
                opts=_replicated(opts.state), reps=reps, runs=runs, runs_mesh=runs_mesh,
                seconds=time.perf_counter() - t0)


def test_mesh_trainer_matches_single_device(trainer_runs):
    r = trainer_runs
    tmp = r["tmp"]
    h1, h2 = r["hist"], r["hist_mesh"]
    assert len(h1) == len(h2) == 5
    np.testing.assert_allclose(h2[0]["loss"], h1[0]["loss"], rtol=1e-5)
    # the first step's gradients: Adam's first moments after it
    z1 = np.load(tmp / "single" / "ckpts" / "ckpt_1.npz")
    z2 = np.load(tmp / "mesh" / "ckpts" / "ckpt_1.npz")
    assert sorted(z1.files) == sorted(z2.files)
    for k in z1.files:
        assert z1[k].shape == z2[k].shape, k
        if k.startswith("opt_m"):  # shN: the SH ramp masks it at step 1
            scale = np.abs(z1[k]).max()
            assert np.abs(z2[k] - z1[k]).max() <= 5e-4 * scale, k
            assert scale > 0 or k == "opt_m['shN']", k
    # the refine (after step 3): its counts, the same growth
    refine = [i for i, h in enumerate(h1) if "n_split" in h]
    assert refine == [2] and [i for i, h in enumerate(h2) if "n_split" in h] == refine
    for k in ("n_dupli", "n_split", "n_prune", "n_granted"):
        assert h2[2][k] == h1[2][k], k
    assert h1[2]["n_split"] + h1[2]["n_dupli"] > 0
    assert [h["num_GS"] for h in h2] == [h["num_GS"] for h in h1]
    np.testing.assert_allclose([h["loss"] for h in h2], [h["loss"] for h in h1],
                               rtol=2e-2, atol=2e-3)
    # the eval at step 5: every rank renders, rank 0 writes
    stats = [json.loads((tmp / d / "stats" / "val_step0005.json").read_text())
             for d in ("single", "mesh")]
    assert stats[1]["num_GS"] == stats[0]["num_GS"]
    assert abs(stats[1]["psnr"] - stats[0]["psnr"]) < 1e-2, stats


def test_mesh_trainer_grows_and_relocates_alike(trainer_runs):
    """Capacity growth and MCMC's relocation under the mesh: every rank
    logs the same history and keeps the same capacity; the growth happens
    where the single-device Trainer's does (each shard grows its own rows),
    and MCMC's first loss (before any refine) is the single-device one."""
    single, ranks = trainer_runs["runs"], trainer_runs["runs_mesh"]

    def logged(hist):  # all but the host clock
        return [{k: v for k, v in h.items() if k != "time_s"} for h in hist]

    for r in ranks[1:]:
        for name in ("grow", "mcmc"):
            assert logged(r[name]["hist"]) == logged(ranks[0][name]["hist"]), name
            assert r[name]["capacity"] == ranks[0][name]["capacity"], name
    grow = ranks[0]["grow"]
    assert single["grow"]["capacity"] == grow["capacity"] == 640
    assert grow["rows"] == 320  # each of the 2 gauss shards: half the rows
    assert [h["num_GS"] for h in grow["hist"]] == [
        h["num_GS"] for h in single["grow"]["hist"]]
    mcmc = ranks[0]["mcmc"]
    np.testing.assert_allclose(mcmc["hist"][0]["loss"], single["mcmc"]["hist"][0]["loss"],
                               rtol=1e-5)
    assert any("n_relocated" in h for h in mcmc["hist"])
    assert all(np.isfinite(h["loss"]) and h["num_GS"] <= 600 for h in mcmc["hist"])


def test_mesh_trainer_checkpoints(trainer_runs):
    """The gathered npz is the single-device one's (keys, shapes) and serves
    through the viewer's loader; a sharded checkpoint round-trips (checked
    in the world) and refuses another mesh shape."""
    from splat_one_tpu_torch.app import viewer
    from splat_one_tpu_torch.train.trainer import Trainer

    r = trainer_runs
    tmp = r["tmp"]
    z1 = np.load(tmp / "single" / "ckpts" / "ckpt_5.npz")
    z2 = np.load(tmp / "mesh" / "ckpts" / "ckpt_5.npz")
    assert {k: z1[k].shape for k in z1.files} == {k: z2[k].shape for k in z2.files}
    params, alive = viewer.load_checkpoint_params(str(tmp / "mesh" / "ckpts" / "ckpt_5.npz"),
                                                  device="cpu")
    assert int(alive.sum()) == r["hist_mesh"][-1]["num_GS"]
    fn = viewer.make_render_fn(params, alive, 48, 48, sh_degree=1, device="cpu")
    scene = r["single"].scene
    rgb, _, a, _ = fn.render(scene.camtoworlds[1], scene.Ks[1])
    assert torch.isfinite(rgb).all() and float(a.max()) > 0.1
    sharded = tmp / "mesh" / "ckpts" / "sharded_5"
    with open(sharded / "index.json") as f:
        index = json.load(f)
    assert index["mesh"] == {"data": 2, "gauss": 2} and len(index["files"]) == WORLD
    assert all((sharded / name).exists() for name in index["files"])
    one = Trainer(_train_cfg(str(tmp / "one")), scene, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        one.load_checkpoint_sharded(str(sharded))


def test_mesh_trainer_replicated_modules(trainer_runs):
    r = trainer_runs
    # the first step's gradients: each module's Adam first moments after it
    z1 = np.load(r["tmp"] / "single_opts" / "ckpts" / "ckpt_1.npz")
    z2 = np.load(r["tmp"] / "opts" / "ckpts" / "ckpt_1.npz")
    moments = [k for k in z1.files if k.split("_m[")[0] in ("pose", "bil", "app")]
    assert {k.split("_m[")[0] for k in moments} == {"pose", "bil", "app"}
    for k in moments:
        scale = np.abs(z1[k]).max()
        assert scale > 0, k
        assert np.abs(z2[k] - z1[k]).max() <= 5e-4 * scale, k
    for k, want in r["opts"].items():
        for rep in r["reps"][1:]:
            np.testing.assert_array_equal(rep[k], r["reps"][0][k], err_msg=k)
        got = r["reps"][0][k]
        rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-12)
        assert rel < 1e-2, f"{k}: {rel:.3e}"
