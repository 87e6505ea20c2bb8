"""Training engine: counterpart of ``splat_one_tpu/train/trainer.py`` on one
device.

A host loop over train / refine / reset / eval steps on fixed-capacity
splat buffers, as in the JAX package: densification never resizes a
buffer (an ``alive`` mask; ``_grow_capacity`` doubles them when they are
nearly full), the SH degree ramps by masking coefficient bands, Adam is
the per-parameter one of ``train.optimizers``. A step differentiates the
L1 + D-SSIM loss through ``rasterization`` (projection by autograd, the
compositing kernels' backward, the segmented reduce) with
``torch.autograd.grad`` and updates the state functionally.

Checkpoints use the JAX Trainer's npz keys (``params['means']``,
``opt_m[...]``, ``opt_v[...]``, ``opt_count``, ``alive``, ``step``,
``strat_grad2d``, ``strat_count``), so a JAX checkpoint resumes here and
``app.viewer.load_checkpoint_params`` reads this Trainer's.

Runs on CUDA unless ``device="cpu"``. Not ported yet, and refused:
pose optimisation, the appearance model, the bilateral grid, the tiled
rasterizer, the MCMC strategy and mesh (multi-GPU) training; LPIPS in
``eval`` is reported as None, as the JAX Trainer does without weights.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from splat_one_tpu_torch.core import gaussians as G
from splat_one_tpu_torch.core.sh import num_sh_bases
from splat_one_tpu_torch.core.transforms import invert_se3
from splat_one_tpu_torch.ops.ssim import ssim as ssim_fn
from splat_one_tpu_torch.ops.stream_isect import StreamCaps, supertile_grid
from splat_one_tpu_torch.render.rasterization import rasterization
from splat_one_tpu_torch.train import losses as L
from splat_one_tpu_torch.train import optimizers as opt
from splat_one_tpu_torch.train import strategy as S
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.strategy import MCMCStrategyCfg
from splat_one_tpu_torch.utils.device import resolve as resolve_device
from splat_one_tpu_torch.utils.tensorboard import SummaryWriter


class SceneData(NamedTuple):
    """Host-side training data (the JAX package's ``SceneData``)."""

    camtoworlds: np.ndarray  # [M, 4, 4]
    Ks: np.ndarray  # [M, 3, 3]
    images: np.ndarray  # [M, H, W, 3] float32 in [0, 1] (or uint8)
    points: np.ndarray  # [Npts, 3] SfM points
    points_rgb: np.ndarray  # [Npts, 3] in [0, 1]
    scene_scale: float
    camera_model: str = "pinhole"
    depths: Optional[np.ndarray] = None  # [M, H, W, 1] optional supervision
    image_names: Optional[list] = None


class TrainState(NamedTuple):
    params: Dict[str, torch.Tensor]
    opt_state: opt.AdamState
    alive: torch.Tensor
    strat: S.StrategyState
    step: int


# Config flags whose modules are not ported yet (ROADMAP Queue 1 places
# them after Slice C, the gen-1 rasterizer).
_NOT_PORTED = (
    ("pose_opt", "pose optimisation (train/pose_opt.py)"),
    ("app_opt", "the appearance model (train/appearance.py)"),
    ("use_bilateral_grid", "the bilateral grid (train/bilateral_grid.py)"),
)


def _sh_band_degrees(sh_degree: int) -> np.ndarray:
    """Degree of each non-DC SH coefficient row (rows 1..K-1)."""
    K = num_sh_bases(sh_degree)
    return np.array([int(np.floor(np.sqrt(i))) for i in range(1, K)], np.int32)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


class Trainer:
    """Trains, evaluates and renders one scene on one device."""

    def __init__(self, cfg: Config, scene: SceneData, result_dir: str = None,
                 mesh=None, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "mesh (multi-GPU) training is not ported yet: it comes with "
                "the multi-GPU slice (Slice E)")
        self.device = resolve_device(device)
        self.cfg = cfg.adjust_steps()
        cfg = self.cfg
        for flag, what in _NOT_PORTED:
            if getattr(cfg, flag):
                raise NotImplementedError(
                    f"{flag}: {what} is not ported yet; it follows Slice C")
        if cfg.raster_impl != "stream":
            raise NotImplementedError(
                "raster_impl='tiled' is not ported yet: it comes with the "
                "gen-1 cross-check rasterizer slice (Slice C)")
        if isinstance(cfg.strategy, MCMCStrategyCfg):
            raise NotImplementedError(
                "the MCMC strategy (mcmc_refine, mcmc_noise) is not ported "
                "yet; it follows Slice C")
        self.scene = scene
        if scene.camera_model and scene.camera_model != cfg.camera_model:
            # the data's camera model is authoritative: a mismatched
            # projection can still fit the training views while held-out
            # views collapse
            logging.getLogger("splat_one_tpu_torch").warning(
                "camera_model mismatch: scene=%s cfg=%s - using the scene's model",
                scene.camera_model, cfg.camera_model)
            cfg.camera_model = scene.camera_model
        self.result_dir = result_dir or cfg.result_dir
        for sub in ("ckpts", "stats"):
            os.makedirs(os.path.join(self.result_dir, sub), exist_ok=True)

        M, H, W = scene.images.shape[:3]
        self.height, self.width = H, W
        self.n_images = M
        idx = np.arange(M)
        self.val_idx = idx[idx % cfg.test_every == 0]
        self.train_idx = idx[idx % cfg.test_every != 0]

        n0 = scene.points.shape[0] if cfg.init_type == "sfm" else cfg.init_num_pts
        capacity = cfg.capacity or _next_pow2(int(n0 * cfg.capacity_headroom))
        kw = dict(sh_degree=cfg.sh_degree, init_opacity=cfg.init_opa,
                  init_scale=cfg.init_scale, seed=cfg.seed, device=self.device)
        if cfg.init_type == "sfm":
            params, alive = G.init_splats_from_points(
                scene.points, scene.points_rgb, capacity, **kw)
        else:
            params, alive = G.init_splats_random(
                capacity, cfg.init_num_pts, cfg.init_extent * scene.scene_scale, **kw)
        self.capacity = capacity
        self.state = TrainState(
            params=params, opt_state=opt.adam_init(params), alive=alive,
            strat=S.strategy_init(capacity, self.device), step=0)
        self._isect_mult = cfg.avg_supertiles_per_gaussian
        self.caps = self._choose_caps(capacity)
        # every random draw of step s comes from this generator reseeded
        # with (seed, s), so a resumed run replays an uninterrupted one
        self.gen = torch.Generator(device=self.device)
        self._band_deg = torch.as_tensor(_sh_band_degrees(cfg.sh_degree),
                                         device=self.device)
        self._hp = opt.adam_hparams(cfg.batch_size)
        self._lrs_base = opt.base_lrs(scene.scene_scale * cfg.global_scale)
        self._build_steps()

    # ------------------------------------------------------------------
    def _choose_caps(self, capacity: int) -> StreamCaps:
        """Stream intersection capacities for ``capacity`` gaussians."""
        _, _, sw, sh = supertile_grid(self.width, self.height, self.cfg.tile_size)
        B = self.cfg.batch_size
        return StreamCaps.choose(capacity, B, B * sw * sh,
                                 avg_supertiles_per_gaussian=self._isect_mult)

    def _grow_isect_caps(self, n_isect: float = None):
        """Intersection-capacity overflow: raise the per-gaussian budget
        (sized from the measured ``n_isect`` when known) and rebuild the
        steps, so no later step silently drops intersections."""
        need = 1.5 * self._isect_mult
        if n_isect:
            need = max(need, 1.3 * float(n_isect)
                       / (self.cfg.batch_size * self.capacity))
        self._isect_mult = need
        self.caps = self._choose_caps(self.capacity)
        self._build_steps()

    def _seed(self, step: int):
        self.gen.manual_seed((self.cfg.seed << 32) + step)

    # ------------------------------------------------------------------
    def _build_steps(self):
        """The step functions over the current caps: ``_train_step``,
        ``_refine_step``, ``_reset_step`` and ``_eval_render``."""
        cfg = self.cfg
        W, H = self.width, self.height
        caps = self.caps
        hp = self._hp
        dev = self.device
        band_deg = self._band_deg
        use_abs = cfg.strategy.absgrad

        def render(params, alive, camtoworlds, Ks, step, camera_model,
                   m2d=None, absd=None):
            # SH bands above the ramp's current degree are masked out
            active = min(step // cfg.sh_degree_interval, cfg.sh_degree)
            mask = (band_deg <= active).float()[None, :, None]
            sh = torch.cat([params["sh0"], params["shN"] * mask], dim=1)
            return rasterization(
                params["means"], params["quats"], torch.exp(params["scales"]),
                torch.sigmoid(params["opacities"]), sh, invert_se3(camtoworlds),
                Ks, W, H, sh_degree=cfg.sh_degree,
                near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                tile_size=cfg.tile_size, camera_model=camera_model,
                render_mode="RGB+ED",
                rasterize_mode="antialiased" if cfg.antialiased else "classic",
                caps=caps, alive=alive, means2d_dummy=m2d, absgrad_dummy=absd)

        def train_step(state: TrainState, batch):
            step = state.step
            B = batch["camtoworld"].shape[0]
            cap = state.alive.shape[0]
            params = {k: v.detach().requires_grad_(True)
                      for k, v in state.params.items()}
            # zero hooks whose gradients are the densification statistics
            m2d = torch.zeros((B, cap, 2), device=dev, requires_grad=True)
            absd = (torch.zeros((B, cap, 2), device=dev, requires_grad=True)
                    if use_abs else None)
            out, alpha, info = render(params, state.alive, batch["camtoworld"],
                                      batch["K"], step, cfg.camera_model, m2d, absd)
            rgb = out[..., 0:3]
            if cfg.random_bkgd:
                bkgd = torch.rand((1, 1, 1, 3), generator=self.gen, device=dev)
                rgb = rgb + bkgd * (1.0 - alpha)
            m = L.image_loss(rgb, batch["image"], cfg.ssim_lambda)
            loss = m["loss"]
            if cfg.depth_loss and "depth" in batch:
                dl = L.depth_loss(out[..., 3:4], batch["depth"],
                                  scene_scale=self.scene.scene_scale)
                loss = loss + cfg.depth_lambda * dl
                m["depthloss"] = dl
            loss = loss + L.regularizers(params, state.alive, cfg.opacity_reg,
                                         cfg.scale_reg)
            wrt = list(params.values()) + [absd if use_abs else m2d]
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, wrt)]
            gp = dict(zip(params, grads[:-1]))
            radii = info["radii_local"]
            strat = S.strategy_update(state.strat, grads[-1], radii, W, H)

            lrs = {k: v * hp["lr_scale"] for k, v in self._lrs_base.items()}
            lrs["means"] = lrs["means"] * opt.means_lr_decay(step, cfg.max_steps).to(dev)
            visible = torch.any(radii > 0, dim=0) if cfg.visible_adam else None
            new_params, opt_state = opt.adam_update(
                gp, state.opt_state, state.params, lrs, b1=hp["b1"],
                b2=hp["b2"], eps=hp["eps"], visible_mask=visible)
            metrics = {k: v.detach() for k, v in m.items()}
            metrics["loss"] = loss.detach()
            metrics["n_isect"] = info["n_isect"]
            metrics["overflow"] = info["overflow"]
            return TrainState(params=new_params, opt_state=opt_state,
                              alive=state.alive, strat=strat, step=step + 1), metrics

        def refine_step(state: TrainState):
            cap = state.alive.shape[0]
            noise = tuple(torch.randn((cap, 3), generator=self.gen, device=dev)
                          for _ in range(2))
            params, opt_state, alive, strat, info = S.default_refine(
                noise, state.params, state.opt_state, state.alive, state.strat,
                state.step, cfg.strategy, self.scene.scene_scale)
            return state._replace(params=params, opt_state=opt_state,
                                  alive=alive, strat=strat), info

        def reset_step(state: TrainState):
            params, opt_state = S.reset_opacity(
                state.params, state.opt_state, state.alive, cfg.strategy.prune_opa)
            return state._replace(params=params, opt_state=opt_state)

        @torch.no_grad()
        def eval_render(state: TrainState, camtoworld, K, camera_model=None):
            out, alpha, _ = render(state.params, state.alive, camtoworld, K,
                                   cfg.max_steps, camera_model or cfg.camera_model)
            return torch.clamp(out[..., 0:3], 0.0, 1.0), alpha, out[..., 3:4]

        self._train_step = train_step
        self._refine_step = refine_step
        self._reset_step = reset_step
        self._eval_render = eval_render

    # ------------------------------------------------------------------
    _DEVICE_IMAGE_BUDGET = 2 << 30  # keep images on the device under 2 GiB

    def _batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        imgs_src = self.scene.images
        f32_bytes = imgs_src.nbytes * (4 if imgs_src.dtype == np.uint8 else 1)
        if f32_bytes < self._DEVICE_IMAGE_BUDGET:
            # small scenes live on the device once; a batch is a gather
            if not hasattr(self, "_dev_images"):
                f = imgs_src.astype(np.float32)
                if imgs_src.dtype == np.uint8:
                    f = f / 255.0
                self._dev_images = torch.as_tensor(f, device=self.device)
            imgs = self._dev_images[torch.as_tensor(idx, device=self.device)]
        else:
            imgs = imgs_src[idx]
            if imgs.dtype == np.uint8:
                imgs = imgs.astype(np.float32) / 255.0
            imgs = torch.as_tensor(imgs, device=self.device)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        b = {
            "camtoworld": t(self.scene.camtoworlds[idx]),
            "K": t(self.scene.Ks[idx]),
            "image": imgs,
        }
        if self.cfg.depth_loss and self.scene.depths is not None:
            b["depth"] = t(self.scene.depths[idx])
        return b

    def train(self, log_every: int = 100, stop_flag=None):
        """The training loop -> history of logged metrics."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        strat_cfg = cfg.strategy
        t_start = time.time()
        perm = rng.permutation(self.train_idx)
        pos = 0
        history = []
        tb = SummaryWriter(os.path.join(self.result_dir, "tb"))
        prev_overflow = None  # one step late, so the check overlaps compute

        def draw_idx():
            nonlocal perm, pos
            if pos + cfg.batch_size > len(perm):
                perm = rng.permutation(self.train_idx)
                pos = 0
            out = perm[pos:pos + cfg.batch_size]
            pos += cfg.batch_size
            return out

        # resume: the batch order depends only on the seed and the steps
        # taken, so replaying the draws continues an interrupted run exactly
        for _ in range(self.state.step):
            draw_idx()
        idx = draw_idx()
        try:
            for step in range(self.state.step, cfg.max_steps):
                if stop_flag is not None and stop_flag():
                    break
                self._seed(step)
                self.state, metrics = self._train_step(self.state, self._batch(idx))
                idx = draw_idx()
                # intersection overflow -> grow caps; sampled every 10 steps
                # so the host does not wait on the device every step
                if prev_overflow is not None and bool(prev_overflow[0]):
                    self._grow_isect_caps(float(prev_overflow[1]))
                    prev_overflow = None
                elif step % 10 == 9:
                    prev_overflow = (metrics["overflow"], metrics["n_isect"])
                else:
                    prev_overflow = None
                if (strat_cfg.refine_start_iter <= step < strat_cfg.refine_stop_iter
                        and (step + 1) % strat_cfg.refine_every == 0):
                    self.state, _ = self._refine_step(self.state)
                    if int(G.n_alive(self.state.alive)) / self.capacity > 0.9:
                        self._grow_capacity(self.capacity * 2)
                if ((step + 1) % strat_cfg.reset_every == 0
                        and step < strat_cfg.refine_stop_iter):
                    self.state = self._reset_step(self.state)

                if (step + 1) % log_every == 0 or step == cfg.max_steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step + 1
                    m["num_GS"] = int(G.n_alive(self.state.alive))
                    m["time_s"] = time.time() - t_start
                    history.append(m)
                if (step + 1) % cfg.tb_every == 0:
                    for k in ("loss", "l1", "ssim"):
                        tb.add_scalar(f"train/{k}", float(metrics[k]), step + 1)
                    tb.add_scalar("train/num_GS", int(G.n_alive(self.state.alive)),
                                  step + 1)
                    tb.flush()
                if (step + 1) in cfg.save_steps:
                    self.save_checkpoint(step + 1)
                    stats = {"step": step + 1,
                             "ellipse_time": time.time() - t_start,
                             "num_GS": int(G.n_alive(self.state.alive))}
                    with open(os.path.join(self.result_dir, "stats",
                                           f"train_step{step + 1:04d}.json"), "w") as f:
                        json.dump(stats, f)
                if (step + 1) in cfg.eval_steps:
                    self.eval(step + 1)
        finally:
            tb.close()
        return history

    # ------------------------------------------------------------------
    def _grow_capacity(self, new_capacity: int):
        """Double the splat buffers, the Adam moments and the strategy
        state, and rebuild the steps for the new caps."""
        st = self.state
        params, alive = G.grow_capacity(st.params, st.alive, new_capacity)
        m, _ = G.grow_capacity(st.opt_state.m, st.alive, new_capacity)
        v, _ = G.grow_capacity(st.opt_state.v, st.alive, new_capacity)
        self.state = st._replace(
            params=params, alive=alive,
            opt_state=opt.AdamState(m=m, v=v, count=st.opt_state.count),
            strat=S.strategy_init(new_capacity, self.device))
        self.capacity = new_capacity
        self.caps = self._choose_caps(new_capacity)
        self._build_steps()

    def eval(self, step: int, stage: str = "val") -> Dict[str, float]:
        """PSNR and SSIM over the validation split; stats JSON under
        ``stats/``. LPIPS is None: its weights are not in the repository,
        as the JAX Trainer reports without them."""
        psnrs, ssims, times = [], [], []
        for i in self.val_idx:
            b = self._batch(np.array([i]))
            t0 = time.time()
            rgb, _, _ = self._eval_render(self.state, b["camtoworld"], b["K"])
            if rgb.is_cuda:
                torch.cuda.synchronize(rgb.device)
            times.append(time.time() - t0)
            psnrs.append(float(L.psnr(rgb, b["image"])))
            ssims.append(float(ssim_fn(rgb, b["image"])))
        stats = {
            "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "ssim": float(np.mean(ssims)) if ssims else 0.0,
            "lpips": None,
            "ellipse_time": float(np.mean(times[1:])) if len(times) > 1 else 0.0,
            "num_GS": int(G.n_alive(self.state.alive)),
        }
        if self.device.type == "cuda":
            stats["mem"] = torch.cuda.max_memory_allocated(self.device) / 2**30
        with open(os.path.join(self.result_dir, "stats",
                               f"{stage}_step{step:04d}.json"), "w") as f:
            json.dump(stats, f)
        return stats

    # ------------------------------------------------------------------
    def save_checkpoint(self, step: int) -> str:
        """npz with the JAX Trainer's keys: params, Adam moments and
        count, alive, step and the strategy state."""
        path = os.path.join(self.result_dir, "ckpts", f"ckpt_{step}.npz")
        st = self.state
        host = lambda x: x.detach().cpu().numpy()
        flat = {}
        for prefix, tree in (("params", st.params), ("opt_m", st.opt_state.m),
                             ("opt_v", st.opt_state.v)):
            flat.update({f"{prefix}['{k}']": host(v) for k, v in tree.items()})
        flat["opt_count"] = host(st.opt_state.count)
        flat["alive"] = host(st.alive)
        flat["step"] = np.asarray(st.step, np.int32)
        flat["strat_grad2d"] = host(st.strat.grad2d)
        flat["strat_count"] = host(st.strat.count)
        np.savez(path, **flat)
        return path

    def load_checkpoint(self, path: str):
        """Resume from an npz written by this Trainer or the JAX one."""
        dev = self.device
        with np.load(path) as z:
            extra = [k for k in z.files
                     if k.split("[")[0] in ("pose_params", "pose_m", "bil_grids",
                                            "bil_m", "app", "app_m")]
            if extra:
                raise NotImplementedError(
                    f"{path}: pose / bilateral / appearance state ({extra[0]}, ...) "
                    "is not ported yet")

            def tree(prefix):
                return {k.split("['")[1].rstrip("']"): torch.as_tensor(z[k], device=dev)
                        for k in z.files if k.startswith(prefix + "[")}

            params = tree("params")
            alive = torch.as_tensor(z["alive"], device=dev)
            strat = (S.StrategyState(
                grad2d=torch.as_tensor(z["strat_grad2d"], device=dev),
                count=torch.as_tensor(z["strat_count"], device=dev))
                if "strat_grad2d" in z.files
                else S.strategy_init(alive.shape[0], dev))
            self.state = TrainState(
                params=params,
                opt_state=opt.AdamState(
                    m=tree("opt_m"), v=tree("opt_v"),
                    count=torch.as_tensor(z["opt_count"], device=dev)),
                alive=alive, strat=strat, step=int(z["step"]))
        if alive.shape[0] != self.capacity:
            # saved after a capacity growth: resize the caps with it
            self.capacity = int(alive.shape[0])
            self.caps = self._choose_caps(self.capacity)
            self._build_steps()

    # ------------------------------------------------------------------
    def render_view(self, camtoworld: np.ndarray, K: np.ndarray,
                    camera_model: str = None):
        """One view -> (rgb [H, W, 3], expected depth [H, W, 1]) as numpy;
        ``camera_model`` overrides the training model (the viewer's
        pinhole <-> spherical toggle)."""
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)[None]
        rgb, _, depth = self._eval_render(self.state, t(camtoworld), t(K), camera_model)
        return rgb[0].cpu().numpy(), depth[0].cpu().numpy()
