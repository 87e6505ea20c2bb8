"""Training engine: counterpart of ``splat_one_tpu/train/trainer.py``.

A host loop over train / refine / reset / eval steps on fixed-capacity
splat buffers, as in the JAX package: densification never resizes a
buffer (an ``alive`` mask; ``_grow_capacity`` doubles them when they are
nearly full), the SH degree ramps by masking coefficient bands, Adam is
the per-parameter one of ``train.optimizers``. A step differentiates the
L1 + D-SSIM loss through ``rasterization`` (projection by autograd, the
compositing kernels' backward, the segmented reduce) with
``torch.autograd.grad`` and updates the state functionally.

Options, as in the JAX Trainer: the MCMC strategy (relocation and growth
at each refine, noise on the means every step; no capacity growth and no
opacity reset), per-image pose embeddings (``pose_opt``: their gradients
reach them through the view matrices), per-image bilateral grids applied
to the render (``use_bilateral_grid``, with ``cc_psnr`` in ``eval``), the
appearance MLP (``app_opt``: per-camera colours in place of SH) and the
depth loss on ``SceneData.depths``. ``run`` trains, or with
``Config.ckpt`` loads a checkpoint and evaluates, renders the trajectory
(``render_traj``) and, with ``compression="png"``, evaluates the
compressed splats (``run_compression``).

Checkpoints use the JAX Trainer's npz keys (``params['means']``,
``opt_m[...]``, ``opt_v[...]``, ``opt_count``, ``alive``, ``step``,
``strat_grad2d``, ``strat_count``; ``pose_params``, ``pose_m[...]``,
``bil_grids``, ``bil_m[...]``, ``app[...]``, ``app_m[...]`` and their
``_v`` / ``_count`` with the options), so a JAX checkpoint resumes here and
``app.viewer.load_checkpoint_params`` reads this Trainer's.

Runs on CUDA unless ``device="cpu"``; ``Config.raster_impl`` picks the
stream rasterizer (default) or the gen-1 tiled one, through the type of
the intersection caps. LPIPS in ``eval`` is reported as None, as the JAX
Trainer does without weights.

Multi-GPU: ``Trainer(cfg, scene, mesh=parallel.multihost.global_mesh(
n_data, n_gauss))`` runs the same steps in every process of a
``torch.distributed`` world (one per GPU, e.g. under ``torchrun``). The
camera batch is split over ``data``; the splat buffers, their Adam
moments, the strategy state and ``alive`` over ``gauss``, on the
capacity axis (shard g holds rows ``[g * cap / n_gauss, (g + 1) * cap /
n_gauss)`` of the single-device buffers). A step projects the rank's
shard, all-gathers the projected fields over ``gauss`` (both values of
``Config.gauss_exchange`` take this one exchange), composites the
rank's supertile slab and gathers the slabs into the image, so every
gauss rank computes the same loss. The gradients are the single-device
Trainer's: the exchange's backward sends each shard's field gradients
home and a rank's slab cotangent only to its own slab (no n_gauss-fold
sum); splat gradients are averaged over ``data``; pose and appearance
gradients (which carry only the rank's own gaussians) are summed over
``gauss`` and averaged over ``data``; the bilateral grid's (whole on
every gauss rank) are averaged over both. Densification statistics are
the gradients of the global camera mean. Every host decision that
changes the sequence of collectives (cap growth, capacity growth,
refine, reset) is taken from all-reduced values; logs, TensorBoard,
stats and the checkpoint's npz are written by rank 0 only.
``save_checkpoint`` gathers the shards into the single-device npz;
``save_checkpoint_sharded`` writes one npz per rank.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import subprocess
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from splat_one_tpu_torch.core import gaussians as G
from splat_one_tpu_torch.core.sh import num_sh_bases
from splat_one_tpu_torch.core.transforms import invert_se3
from splat_one_tpu_torch.data import traj as traj_mod
from splat_one_tpu_torch.models import lpips as lpips_mod
from splat_one_tpu_torch.ops.intersect import IsectCaps
from splat_one_tpu_torch.ops.ssim import ssim as ssim_fn
from splat_one_tpu_torch.ops.stream_isect import StreamCaps, supertile_grid
from splat_one_tpu_torch.parallel import comm
from splat_one_tpu_torch.render.rasterization import rasterization
from splat_one_tpu_torch.train import appearance as APP
from splat_one_tpu_torch.train import bilateral_grid as BG
from splat_one_tpu_torch.train import compression as comp
from splat_one_tpu_torch.train import losses as L
from splat_one_tpu_torch.train import optimizers as opt
from splat_one_tpu_torch.train import pose_opt as P
from splat_one_tpu_torch.train import strategy as S
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.strategy import MCMCStrategyCfg
from splat_one_tpu_torch.utils.device import resolve as resolve_device
from splat_one_tpu_torch.utils.profiling import memory_stats
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
    pose_params: Optional[torch.Tensor] = None
    pose_opt_state: Optional[opt.AdamState] = None
    bil_grids: Optional[torch.Tensor] = None
    bil_opt_state: Optional[opt.AdamState] = None
    app_params: Optional[Dict[str, torch.Tensor]] = None
    app_opt_state: Optional[opt.AdamState] = None



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
    """Trains, evaluates and renders one scene, on one device or, with
    ``mesh`` (``parallel.train_step.Mesh``), as one rank of a (data,
    gauss) mesh on the mesh's device."""

    def __init__(self, cfg: Config, scene: SceneData, result_dir: str = None,
                 mesh=None, device="cuda"):
        self.mesh = mesh
        if mesh is None:
            self.device = resolve_device(device)
        else:
            if torch.device(device).type != mesh.device.type:
                raise ValueError(f"device {device} differs from the mesh's {mesh.device}")
            self.device = mesh.device
        self._primary = mesh is None or mesh.rank == 0
        self.cfg = cfg.adjust_steps()
        cfg = self.cfg
        if cfg.raster_impl not in ("stream", "tiled"):
            raise ValueError(f"bad raster_impl {cfg.raster_impl!r}")
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
        for sub in ("ckpts", "stats", "renders", "videos"):
            os.makedirs(os.path.join(self.result_dir, sub), exist_ok=True)

        M, H, W = scene.images.shape[:3]
        self.height, self.width = H, W
        self.n_images = M
        idx = np.arange(M)
        self.val_idx = idx[idx % cfg.test_every == 0]
        self.train_idx = idx[idx % cfg.test_every != 0]

        n0 = scene.points.shape[0] if cfg.init_type == "sfm" else cfg.init_num_pts
        capacity = cfg.capacity or _next_pow2(int(n0 * cfg.capacity_headroom))
        if isinstance(cfg.strategy, MCMCStrategyCfg):
            capacity = max(capacity, _next_pow2(cfg.strategy.cap_max))
        if mesh is not None:
            if cfg.raster_impl != "stream":
                # the tiled rasterizer has no supertile slabs: every gauss
                # rank would composite the whole image
                raise ValueError("mesh training requires raster_impl='stream'")
            if cfg.gauss_exchange not in ("ring", "all_gather"):
                raise ValueError(f"gauss_exchange must be 'ring' or 'all_gather', "
                                 f"got {cfg.gauss_exchange!r}")
            capacity = -(-capacity // self._n_gauss) * self._n_gauss
            if cfg.batch_size % mesh.shape["data"]:
                raise ValueError(f"batch_size {cfg.batch_size} must divide over "
                                 f"{mesh.shape['data']} data ranks")
        dev = self.device
        kw = dict(sh_degree=cfg.sh_degree, init_opacity=cfg.init_opa,
                  init_scale=cfg.init_scale, seed=cfg.seed,
                  feature_dim=32 if cfg.app_opt else 0, device=dev)
        if cfg.init_type == "sfm":
            params, alive = G.init_splats_from_points(
                scene.points, scene.points_rgb, capacity, **kw)
        else:
            params, alive = G.init_splats_random(
                capacity, cfg.init_num_pts, cfg.init_extent * scene.scene_scale, **kw)
        self.capacity = capacity  # the whole model's, over every gauss shard
        # a mesh rank keeps its shard's rows of the single-device buffers
        params = {k: self._rows(v) for k, v in params.items()}
        alive = self._rows(alive)
        # every random draw of step s comes from this generator reseeded
        # with (seed, s), so a resumed run replays an uninterrupted one
        self.gen = torch.Generator(device=dev)
        state = dict(params=params, opt_state=opt.adam_init(params), alive=alive,
                     strat=S.strategy_init(alive.shape[0], dev), step=0)
        if cfg.pose_opt:
            state["pose_params"] = P.init_pose_params(M, dev)
            state["pose_opt_state"] = opt.adam_init({"pose": state["pose_params"]})
        if cfg.use_bilateral_grid:
            state["bil_grids"] = BG.init_bilateral_grids(M, cfg.bilateral_grid_shape, dev)
            state["bil_opt_state"] = opt.adam_init({"bil": state["bil_grids"]})
        if cfg.app_opt:
            self.gen.manual_seed(cfg.seed + 1)
            state["app_params"] = APP.init_appearance_params(
                self.gen, M, feature_dim=32, embed_dim=cfg.app_embed_dim,
                sh_degree=cfg.sh_degree)
            state["app_opt_state"] = opt.adam_init(state["app_params"])
        self.state = TrainState(**state)
        self._isect_mult = (cfg.avg_supertiles_per_gaussian
                            if cfg.raster_impl == "stream"
                            else cfg.avg_tiles_per_gaussian)
        self.caps = self._choose_caps(capacity)
        self._band_deg = torch.as_tensor(_sh_band_degrees(cfg.sh_degree), device=dev)
        self._hp = opt.adam_hparams(cfg.batch_size)
        self._lrs_base = opt.base_lrs(scene.scene_scale * cfg.global_scale)
        # the appearance path's per-gaussian parameters
        self._lrs_base.setdefault("features", 2.5e-3)
        self._lrs_base.setdefault("colors", 2.5e-3)
        self._build_steps()

    # ------------------------------------------------------------------
    @property
    def _n_gauss(self) -> int:
        return 1 if self.mesh is None else self.mesh.shape["gauss"]

    def _rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's gauss shard of a whole-model buffer (all of it
        without a mesh)."""
        if self.mesh is None:
            return x
        n = x.shape[0] // self._n_gauss
        return x[self.mesh.g * n:(self.mesh.g + 1) * n].clone()

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole-model buffer from every gauss shard's ``x`` (a
        collective under a mesh)."""
        if self.mesh is None:
            return x
        if x.dtype == torch.bool:
            return self._gather_rows(x.to(torch.uint8)).bool()
        return comm.all_gather(x, self.mesh.gauss_group)

    def _n_alive(self) -> int:
        """Live gaussians of the whole model (summed over the gauss shards,
        the same on every rank)."""
        n = torch.sum(self.state.alive.to(torch.int64))
        if self.mesh is not None:
            n = comm.psum(n, self.mesh.gauss_group)
        return int(n)

    def _local_idx(self, idx: np.ndarray) -> np.ndarray:
        """This data rank's cameras of a batch."""
        if self.mesh is None:
            return idx
        b = len(idx) // self.mesh.shape["data"]
        return idx[self.mesh.d * b:(self.mesh.d + 1) * b]

    def _choose_caps(self, capacity: int):
        """Intersection capacities for ``capacity`` gaussians: stream
        supertile caps, or gen-1 per-tile caps when ``raster_impl`` is
        "tiled" (``rasterization`` picks the backend from their type).
        Under a mesh of several gauss ranks they are per-slab caps: the
        slab build counts exactly its own intersections, so the budget is
        the mean over the n_gauss slabs with 4x slack for their unequal
        loads (JAX ``trainer.py:263-311``; JAX also applies it at
        n_gauss = 1, where the one slab is the whole grid)."""
        ts = self.cfg.tile_size
        B = self.cfg.batch_size
        if self.cfg.raster_impl == "tiled":
            n_tiles = (-(-self.width // ts)) * (-(-self.height // ts))
            return IsectCaps.choose(capacity, B, n_tiles,
                                    avg_tiles_per_gaussian=self._isect_mult)
        _, _, sw, sh = supertile_grid(self.width, self.height, ts)
        mult = self._isect_mult
        if self._n_gauss > 1:
            mult = max(mult * 4.0 / self._n_gauss, 0.75)
        return StreamCaps.choose(capacity, B, B * sw * sh,
                                 avg_supertiles_per_gaussian=mult)

    def _grow_isect_caps(self, n_isect: float = None):
        """Intersection-capacity overflow: raise the per-gaussian budget
        (sized from the measured ``n_isect`` when known) and rebuild the
        steps, so no later step silently drops intersections. Under a
        mesh ``n_isect`` is the largest slab's (summed over data) and the
        slab factor of ``_choose_caps`` is divided back out."""
        need = 1.5 * self._isect_mult
        if n_isect:
            factor = 4.0 / self._n_gauss if self._n_gauss > 1 else 1.0
            need = max(need, 1.3 * float(n_isect)
                       / (self.cfg.batch_size * self.capacity) / factor)
        self._isect_mult = need
        self.caps = self._choose_caps(self.capacity)
        self._build_steps()

    def _seed(self, step: int):
        self.gen.manual_seed((self.cfg.seed << 32) + step)

    def _shard_seed(self, step: int):
        """The seed of a gauss shard's own draws (MCMC relocation) at
        ``step``: each shard draws independently."""
        self.gen.manual_seed(((self.cfg.seed << 32) + step) * 65537 + 1 + self.mesh.g)

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
        is_mcmc = isinstance(cfg.strategy, MCMCStrategyCfg)
        use_abs = (not is_mcmc) and cfg.strategy.absgrad
        strat_cfg = cfg.strategy

        # the mesh's collectives; identities on one device
        mesh = self.mesh
        sharded = mesh is not None
        n_gauss = self._n_gauss
        n_data = mesh.shape["data"] if sharded else 1
        gather = st_shard = None
        if sharded:
            gg, dg = mesh.gauss_group, mesh.data_group
            st_shard = (gg, n_gauss)

            def gather(proj):
                return comm.gather_gauss(proj, gg)

            if is_mcmc:
                # each gauss shard relocates within its share of the budget
                strat_cfg = dataclasses.replace(strat_cfg,
                                                cap_max=strat_cfg.cap_max // n_gauss)

        def psum_gauss(x):
            return comm.psum(x, gg) if sharded else x

        def psum_data(x):
            return comm.psum(x, dg) if sharded else x

        def pmean_data(x):
            return comm.pmean(x, dg) if sharded else x

        def color_input(params, app_params, camtoworlds, image_ids, step):
            """(colours, sh_degree) for ``rasterization``: SH coefficients
            with the bands above the ramp's current degree masked out, or
            the appearance MLP's per-camera colours [B, CAP, 3]."""
            if cfg.app_opt:
                dirs = params["means"][None] - camtoworlds[:, None, :3, 3]
                return APP.appearance_rgb(app_params, params["features"], params["colors"],
                                          image_ids, dirs, cfg.sh_degree), None
            active = min(step // cfg.sh_degree_interval, cfg.sh_degree)
            mask = (band_deg <= active).float()[None, :, None]
            return torch.cat([params["sh0"], params["shN"] * mask], dim=1), cfg.sh_degree

        def render(params, alive, camtoworlds, Ks, step, camera_model, image_ids,
                   app_params, m2d=None, absd=None):
            colors, sh_deg = color_input(params, app_params, camtoworlds, image_ids, step)
            return rasterization(
                params["means"], params["quats"], torch.exp(params["scales"]),
                torch.sigmoid(params["opacities"]), colors, invert_se3(camtoworlds),
                Ks, W, H, sh_degree=sh_deg,
                near_plane=cfg.near_plane, far_plane=cfg.far_plane,
                tile_size=cfg.tile_size, camera_model=camera_model,
                render_mode="RGB+ED",
                rasterize_mode="antialiased" if cfg.antialiased else "classic",
                caps=caps, alive=alive, means2d_dummy=m2d, absgrad_dummy=absd,
                proj_transform=gather, st_shard=st_shard)

        def leaf(x):
            return None if x is None else x.detach().requires_grad_(True)

        def train_step(state: TrainState, batch):
            step = state.step
            B = batch["camtoworld"].shape[0]
            cap = state.alive.shape[0]
            ids = batch["image_id"]
            params = {k: leaf(v) for k, v in state.params.items()}
            pose = leaf(state.pose_params) if cfg.pose_opt else None
            bil = leaf(state.bil_grids) if cfg.use_bilateral_grid else None
            app = ({k: leaf(v) for k, v in state.app_params.items()}
                   if cfg.app_opt else None)
            # zero hooks whose gradients are the densification statistics;
            # under a mesh m2d is shard-shaped (added before the gather) and
            # absd rides the composite of the gathered fields
            m2d = torch.zeros((B, cap, 2), device=dev, requires_grad=True)
            absd = (torch.zeros((B, cap * n_gauss, 2), device=dev, requires_grad=True)
                    if use_abs else None)
            camtoworlds = batch["camtoworld"]
            if cfg.pose_opt:
                camtoworlds = P.apply_pose_adjust(camtoworlds, pose[ids])
            out, alpha, info = render(params, state.alive, camtoworlds, batch["K"],
                                      step, cfg.camera_model, ids, app, m2d, absd)
            rgb = out[..., 0:3]
            if cfg.random_bkgd:
                bkgd = torch.rand((1, 1, 1, 3), generator=self.gen, device=dev)
                rgb = rgb + bkgd * (1.0 - alpha)
            if cfg.use_bilateral_grid:
                rgb = BG.slice_grid(bil[ids], rgb)
            m = L.image_loss(rgb, batch["image"], cfg.ssim_lambda)
            loss = m["loss"]
            if cfg.use_bilateral_grid:
                loss = loss + 10.0 * BG.total_variation_loss(bil[ids])
            if cfg.depth_loss and "depth" in batch:
                dl = L.depth_loss(out[..., 3:4], batch["depth"],
                                  scene_scale=self.scene.scene_scale)
                loss = loss + cfg.depth_lambda * dl
                m["depthloss"] = dl
            # a shard's penalties are its part of the whole model's mean
            reg = L.regularizers(params, state.alive, cfg.opacity_reg, cfg.scale_reg,
                                 n_alive=psum_gauss(torch.sum(state.alive.to(torch.int64)))
                                 if sharded else None)
            loss = loss + reg
            extra = {"pose": pose, "bil": bil, **(app or {})}
            extra = {k: v for k, v in extra.items() if v is not None}
            wrt = list(params.values()) + list(extra.values()) + [absd if use_abs else m2d]
            grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, wrt)]
            gp = dict(zip(params, grads[:len(params)]))
            gx = dict(zip(extra, grads[len(params):-1]))
            radii = info["radii_local"]
            stat = grads[-1]
            if not sharded:
                strat = S.strategy_update(state.strat, stat, radii, W, H)
            else:
                # each data rank's loss is the mean over its own cameras:
                # average the gradients over data. Pose and appearance
                # gradients carry only this rank's gaussians (summed over
                # gauss, averaged over data, in one all-reduce of the
                # world); the bilateral grid's are whole on every gauss
                # rank (averaged over both)
                gp = {k: pmean_data(v) for k, v in gp.items()}
                gx = {k: comm.psum(v, None) / (n_data * (n_gauss if k == "bil" else 1))
                      for k, v in gx.items()}
                if use_abs:
                    # the abs hook holds this slab's |grad| sums of every
                    # gaussian: add the slabs, keep this shard's rows
                    stat = psum_gauss(stat)[:, mesh.g * cap:(mesh.g + 1) * cap]
                delta = S.strategy_update(S.strategy_init(cap, dev), stat, radii, W, H)
                # the statistics of the global camera mean (1 / n_data of
                # the data ranks' sum of per-camera norms)
                strat = S.StrategyState(
                    grad2d=state.strat.grad2d + psum_data(delta.grad2d) / n_data,
                    count=state.strat.count + psum_data(delta.count))

            lrs = {k: v * hp["lr_scale"] for k, v in self._lrs_base.items()}
            lrs["means"] = lrs["means"] * opt.means_lr_decay(step, cfg.max_steps).to(dev)
            visible = None
            if cfg.visible_adam:
                visible = torch.any(radii > 0, dim=0)
                if sharded:
                    visible = psum_data(visible.to(torch.int32)) > 0
            new_params, opt_state = opt.adam_update(
                gp, state.opt_state, state.params, lrs, b1=hp["b1"],
                b2=hp["b2"], eps=hp["eps"], visible_mask=visible)
            new = {}
            if cfg.app_opt:
                g_app = {k: gx[k] + cfg.app_opt_reg * v for k, v in state.app_params.items()}
                new["app_params"], new["app_opt_state"] = opt.adam_update(
                    g_app, state.app_opt_state, state.app_params,
                    {k: cfg.app_opt_lr for k in state.app_params})
            if cfg.use_bilateral_grid:
                bg, new["bil_opt_state"] = opt.adam_update(
                    {"bil": gx["bil"]}, state.bil_opt_state, {"bil": state.bil_grids},
                    {"bil": 2e-3})
                new["bil_grids"] = bg["bil"]
            if cfg.pose_opt:
                pp, new["pose_opt_state"] = opt.adam_update(
                    {"pose": gx["pose"] + cfg.pose_opt_reg * state.pose_params},
                    state.pose_opt_state, {"pose": state.pose_params},
                    {"pose": cfg.pose_opt_lr})
                new["pose_params"] = pp["pose"]
            if is_mcmc:
                # noise on the means every step: a shard takes its rows of
                # the whole model's draw
                eps = self._rows(torch.randn((self.capacity, 3), generator=self.gen,
                                             device=dev))
                new_params = S.mcmc_noise(eps, new_params, state.alive, lrs["means"],
                                          cfg.strategy.noise_lr)
            metrics = {k: v.detach() for k, v in m.items()}
            metrics["loss"] = loss.detach()
            metrics["n_isect"] = info["n_isect"]
            metrics["overflow"] = info["overflow"]
            if sharded:
                # image terms: means over cameras (the same on every gauss
                # rank); the penalties: summed over the shards
                for k in ("l1", "ssim", "depthloss"):
                    if k in metrics:
                        metrics[k] = pmean_data(metrics[k])
                metrics["loss"] = pmean_data(loss.detach() - reg.detach()) + psum_gauss(reg)
                metrics["n_isect"] = psum_data(info["n_isect"])
                metrics["overflow"] = psum_data(info["overflow"].to(torch.int32)) > 0
            return state._replace(params=new_params, opt_state=opt_state, strat=strat,
                                  step=step + 1, **new), metrics

        def refine_step(state: TrainState):
            # a gauss shard refines its own rows; the counts are summed
            cap = state.alive.shape[0]
            if is_mcmc:
                if sharded:
                    self._shard_seed(state.step)
                tgt = S.mcmc_draw_targets(state.params, state.alive, strat_cfg, self.gen)
                params, opt_state, alive, info = S.mcmc_refine(
                    *tgt, state.params, state.opt_state, state.alive, strat_cfg)
                return state._replace(params=params, opt_state=opt_state, alive=alive,
                                      strat=S.strategy_init(cap, dev)), {
                    k: psum_gauss(v) for k, v in info.items()}
            # a shard's rows of the whole model's draws
            noise = tuple(self._rows(torch.randn((self.capacity, 3), generator=self.gen,
                                                 device=dev)) for _ in range(2))
            params, opt_state, alive, strat, info = S.default_refine(
                noise, state.params, state.opt_state, state.alive, state.strat,
                state.step, cfg.strategy, self.scene.scene_scale)
            return state._replace(params=params, opt_state=opt_state,
                                  alive=alive, strat=strat), {
                k: psum_gauss(v) for k, v in info.items()}

        def reset_step(state: TrainState):
            params, opt_state = S.reset_opacity(
                state.params, state.opt_state, state.alive, cfg.strategy.prune_opa)
            return state._replace(params=params, opt_state=opt_state)

        @torch.no_grad()
        def eval_render(state: TrainState, camtoworld, K, image_id, camera_model=None):
            out, alpha, _ = render(state.params, state.alive, camtoworld, K,
                                   cfg.max_steps, camera_model or cfg.camera_model,
                                   image_id, state.app_params)
            return torch.clamp(out[..., 0:3], 0.0, 1.0), alpha, out[..., 3:4]

        self._train_step = train_step
        self._refine_step = refine_step
        self._reset_step = reset_step
        self._eval_render = eval_render

    # ------------------------------------------------------------------
    _DEVICE_IMAGE_BUDGET = 2 << 30  # keep images on the device under 2 GiB

    def _batch(self, idx: np.ndarray) -> Dict[str, torch.Tensor]:
        imgs_src = self.scene.images
        if (isinstance(imgs_src, np.ndarray)
                and imgs_src.nbytes * (4 if imgs_src.dtype == np.uint8 else 1)
                < self._DEVICE_IMAGE_BUDGET):
            # small in-RAM scenes live on the device once; a batch is a
            # gather. Streaming scenes decode on the host (and prefetch)
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
            "image_id": torch.as_tensor(np.asarray(idx, np.int64), device=self.device),
        }
        if self.cfg.depth_loss and self.scene.depths is not None:
            b["depth"] = t(self.scene.depths[idx])
        return b

    def train(self, log_every: int = 100, stop_flag=None):
        """The training loop -> history of logged metrics."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed)
        strat_cfg = cfg.strategy
        is_mcmc = isinstance(strat_cfg, MCMCStrategyCfg)
        streaming = hasattr(self.scene.images, "prefetch")
        t_start = time.time()
        perm = rng.permutation(self.train_idx)
        pos = 0
        history = []
        tb = SummaryWriter(os.path.join(self.result_dir, "tb")) if self._primary else None
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
                self.state, metrics = self._train_step(self.state,
                                                       self._batch(self._local_idx(idx)))
                idx = draw_idx()
                if streaming:
                    # decode the next batch on host threads while this
                    # step runs on the device
                    self.scene.images.prefetch(self._local_idx(idx))
                # intersection overflow -> grow caps; sampled every 10 steps
                # so the host does not wait on the device every step (under
                # a mesh both values are all-reduced: every rank decides
                # alike)
                if prev_overflow is not None and bool(prev_overflow[0]):
                    self._grow_isect_caps(float(prev_overflow[1]))
                    prev_overflow = None
                elif step % 10 == 9:
                    prev_overflow = (metrics["overflow"], metrics["n_isect"])
                else:
                    prev_overflow = None
                if (strat_cfg.refine_start_iter <= step < strat_cfg.refine_stop_iter
                        and (step + 1) % strat_cfg.refine_every == 0):
                    self.state, rinfo = self._refine_step(self.state)
                    metrics = {**metrics, **rinfo}
                    # MCMC keeps its capacity (cap_max sized it)
                    if not is_mcmc and self._n_alive() / self.capacity > 0.9:
                        self._grow_capacity(self.capacity * 2)
                if (not is_mcmc and (step + 1) % strat_cfg.reset_every == 0
                        and step < strat_cfg.refine_stop_iter):
                    self.state = self._reset_step(self.state)

                if (step + 1) % log_every == 0 or step == cfg.max_steps - 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    m["step"] = step + 1
                    m["num_GS"] = self._n_alive()
                    m["time_s"] = time.time() - t_start
                    history.append(m)
                if (step + 1) % cfg.tb_every == 0:
                    n_gs = self._n_alive()
                    if tb is not None:
                        for k in ("loss", "l1", "ssim"):
                            tb.add_scalar(f"train/{k}", float(metrics[k]), step + 1)
                        tb.add_scalar("train/num_GS", n_gs, step + 1)
                        tb.flush()
                if (step + 1) in cfg.save_steps:
                    self.save_checkpoint(step + 1)
                    stats = {"step": step + 1,
                             "ellipse_time": time.time() - t_start,
                             "num_GS": self._n_alive()}
                    if self._primary:
                        with open(os.path.join(self.result_dir, "stats",
                                               f"train_step{step + 1:04d}.json"), "w") as f:
                            json.dump(stats, f)
                if (step + 1) in cfg.eval_steps:
                    self.eval(step + 1)
        finally:
            if tb is not None:
                tb.close()
        return history

    # ------------------------------------------------------------------
    def _grow_capacity(self, new_capacity: int):
        """Double the splat buffers, the Adam moments and the strategy
        state (each gauss shard its own, to ``new_capacity / n_gauss``
        rows), and rebuild the steps for the new caps."""
        st = self.state
        local = new_capacity // self._n_gauss
        params, alive = G.grow_capacity(st.params, st.alive, local)
        m, _ = G.grow_capacity(st.opt_state.m, st.alive, local)
        v, _ = G.grow_capacity(st.opt_state.v, st.alive, local)
        self.state = st._replace(
            params=params, alive=alive,
            opt_state=opt.AdamState(m=m, v=v, count=st.opt_state.count),
            strat=S.strategy_init(local, self.device))
        self.capacity = new_capacity
        self.caps = self._choose_caps(new_capacity)
        self._build_steps()

    def eval(self, step: int, stage: str = "val") -> Dict[str, float]:
        """PSNR, SSIM and LPIPS over the validation split, and with the
        bilateral grid ``cc_psnr`` (PSNR after the per-channel quadratic
        ``color_correct`` fitted to the ground truth); stats JSON under
        ``stats/``. LPIPS is gated on its weight file
        (``models.lpips.DEFAULT_WEIGHTS``, loaded once per eval onto the
        Trainer's device): without one it is None, never a random-weight
        score. Under a mesh every rank renders each view (the step's
        collectives); rank 0 writes."""
        cc = self.cfg.use_bilateral_grid
        lpips_params = lpips_mod.load_weights(device=self.device)
        psnrs, ssims, lpipss, cc_psnrs, times = [], [], [], [], []
        for i in self.val_idx:
            b = self._batch(np.array([i]))
            t0 = time.time()
            rgb, _, _ = self._eval_render(self.state, b["camtoworld"], b["K"],
                                          b["image_id"])
            if rgb.is_cuda:
                torch.cuda.synchronize(rgb.device)
            times.append(time.time() - t0)
            psnrs.append(float(L.psnr(rgb, b["image"])))
            ssims.append(float(ssim_fn(rgb, b["image"])))
            if lpips_params is not None:
                lpipss.append(float(lpips_mod.lpips(lpips_params, rgb, b["image"])))
            if cc:
                cc_psnrs.append(float(L.psnr(BG.color_correct(rgb[0], b["image"][0]),
                                             b["image"][0])))
        stats = {
            "psnr": float(np.mean(psnrs)) if psnrs else 0.0,
            "ssim": float(np.mean(ssims)) if ssims else 0.0,
            "lpips": float(np.mean(lpipss)) if lpipss else None,
            "ellipse_time": float(np.mean(times[1:])) if len(times) > 1 else 0.0,
            "num_GS": self._n_alive(),
        }
        if cc:
            stats["cc_psnr"] = float(np.mean(cc_psnrs)) if cc_psnrs else 0.0
        peaks = [v for k, v in memory_stats().items() if k.endswith("peak_gib")]
        if peaks:
            # the reference reports cuda max_memory_allocated in GiB (:835)
            stats["mem"] = max(peaks)
        if self._primary:
            with open(os.path.join(self.result_dir, "stats",
                                   f"{stage}_step{step:04d}.json"), "w") as f:
                json.dump(stats, f)
        return stats

    # ------------------------------------------------------------------
    def _flat_state(self, rows) -> Dict[str, np.ndarray]:
        """The state as npz entries with the JAX Trainer's keys; ``rows``
        maps each per-gaussian buffer (params, Adam moments, alive,
        strategy) to what is written."""
        st = self.state
        host = lambda x: x.detach().cpu().numpy()
        flat = {}

        def add(prefix, tree, per_gaussian=False):
            flat.update({f"{prefix}['{k}']": host(rows(v) if per_gaussian else v)
                         for k, v in tree.items()})

        def add_opt(prefix, o):
            add(f"{prefix}_m", o.m)
            add(f"{prefix}_v", o.v)
            flat[f"{prefix}_count"] = host(o.count)

        add("params", st.params, True)
        add("opt_m", st.opt_state.m, True)
        add("opt_v", st.opt_state.v, True)
        flat["opt_count"] = host(st.opt_state.count)
        flat["alive"] = host(rows(st.alive))
        flat["step"] = np.asarray(st.step, np.int32)
        flat["strat_grad2d"] = host(rows(st.strat.grad2d))
        flat["strat_count"] = host(rows(st.strat.count))
        if st.pose_params is not None:
            flat["pose_params"] = host(st.pose_params)
            add_opt("pose", st.pose_opt_state)
        if st.bil_grids is not None:
            flat["bil_grids"] = host(st.bil_grids)
            add_opt("bil", st.bil_opt_state)
        if st.app_params is not None:
            add("app", st.app_params)
            add_opt("app", st.app_opt_state)
        return flat

    def save_checkpoint(self, step: int) -> str:
        """npz with the JAX Trainer's keys: params, Adam moments and
        count, alive, step, the strategy state, and the pose, bilateral
        and appearance state with their Adam states where those are on.
        Under a mesh the gauss shards are gathered (every rank takes part)
        into the single-device npz, which rank 0 writes."""
        path = os.path.join(self.result_dir, "ckpts", f"ckpt_{step}.npz")
        flat = self._flat_state(self._gather_rows)
        if self._primary:
            np.savez(path, **flat)
        return path

    def save_checkpoint_sharded(self, step: int) -> str:
        """Every rank writes its own shard of the state (``rank_<r>.npz``
        under ``ckpts/sharded_<step>/``, the keys of ``save_checkpoint``
        plus the mesh's shape), rank 0 an ``index.json``; restore with
        ``load_checkpoint_sharded`` on a mesh of the same shape. Returns
        the directory."""
        path = os.path.join(self.result_dir, "ckpts", f"sharded_{step}")
        os.makedirs(path, exist_ok=True)
        shape = (self.mesh.shape["data"], self.mesh.shape["gauss"]) if self.mesh else (1, 1)
        rank = self.mesh.rank if self.mesh else 0
        flat = self._flat_state(lambda x: x)
        flat["mesh_shape"] = np.asarray(shape, np.int64)
        np.savez(os.path.join(path, f"rank_{rank}.npz"), **flat)
        if self._primary:
            with open(os.path.join(path, "index.json"), "w") as f:
                json.dump({"step": int(self.state.step), "capacity": self.capacity,
                           "mesh": {"data": shape[0], "gauss": shape[1]},
                           "files": [f"rank_{r}.npz" for r in range(shape[0] * shape[1])]},
                          f)
        if self.mesh is not None:
            dist.barrier()
        return path

    def load_checkpoint_sharded(self, path: str):
        """Restore ``save_checkpoint_sharded``'s directory: each rank reads
        its own npz. Raises unless the mesh has the checkpoint's shape."""
        shape = (self.mesh.shape["data"], self.mesh.shape["gauss"]) if self.mesh else (1, 1)
        rank = self.mesh.rank if self.mesh else 0
        with np.load(os.path.join(path, f"rank_{rank}.npz")) as z:
            saved = tuple(int(v) for v in z["mesh_shape"])
        if saved != shape:
            raise ValueError(f"checkpoint of a {saved[0]} x {saved[1]} mesh cannot load on "
                             f"a {shape[0]} x {shape[1]} one")
        self._load(os.path.join(path, f"rank_{rank}.npz"), lambda x: x)

    def load_checkpoint(self, path: str):
        """Resume from an npz written by this Trainer or the JAX one (under a
        mesh each rank takes its shard's rows). State the checkpoint does
        not hold (an option it was saved without) keeps this Trainer's."""
        self._load(path, self._rows)

    def _load(self, path: str, rows):
        """Load the npz at ``path``, each per-gaussian buffer through
        ``rows``; the capacity follows the checkpoint's."""
        dev = self.device
        with np.load(path) as z:
            def tensor(k, per_gaussian=False):
                x = torch.as_tensor(z[k], device=dev)
                return rows(x) if per_gaussian else x

            def tree(prefix, per_gaussian=False):
                return {k.split("['")[1].rstrip("']"): tensor(k, per_gaussian)
                        for k in z.files if k.startswith(prefix + "[")}

            def opt_tree(prefix, current):
                m = tree(prefix + "_m")
                if not m:
                    return current
                return opt.AdamState(m=m, v=tree(prefix + "_v"),
                                     count=tensor(prefix + "_count"))

            st = self.state
            alive = tensor("alive", True)
            strat = (S.StrategyState(grad2d=tensor("strat_grad2d", True),
                                     count=tensor("strat_count", True))
                     if "strat_grad2d" in z.files
                     else S.strategy_init(alive.shape[0], dev))
            self.state = TrainState(
                params=tree("params", True),
                opt_state=opt.AdamState(m=tree("opt_m", True), v=tree("opt_v", True),
                                        count=tensor("opt_count")),
                alive=alive, strat=strat, step=int(z["step"]),
                pose_params=(tensor("pose_params") if "pose_params" in z.files
                             else st.pose_params),
                pose_opt_state=opt_tree("pose", st.pose_opt_state),
                bil_grids=tensor("bil_grids") if "bil_grids" in z.files else st.bil_grids,
                bil_opt_state=opt_tree("bil", st.bil_opt_state),
                app_params=tree("app") or st.app_params,
                app_opt_state=opt_tree("app", st.app_opt_state))
        capacity = int(alive.shape[0]) * self._n_gauss
        if capacity != self.capacity:
            # saved after a capacity growth: resize the caps with it
            self.capacity = capacity
            self.caps = self._choose_caps(self.capacity)
            self._build_steps()

    # ------------------------------------------------------------------
    def run(self):
        """With ``Config.ckpt``: load the checkpoint(s), evaluate, render
        the trajectory and, with ``compression="png"``, evaluate the
        compressed splats; returns the eval stats. Otherwise train and
        return the history."""
        if self.cfg.ckpt:
            ckpts = self.cfg.ckpt
            for path in ckpts if isinstance(ckpts, (list, tuple)) else [ckpts]:
                self.load_checkpoint(path)
            step = self.state.step
            stats = self.eval(step)
            self.render_traj(step)
            if self.cfg.compression == "png":
                self.run_compression(step)
            return stats
        return self.train()

    def render_traj(self, step: int, n_frames: int = 60) -> str:
        """Render the ``Config.render_traj_path`` trajectory (interp,
        ellipse_z, ellipse_y or spiral) through the training cameras:
        RGB | normalized depth frames side by side, PNGs under
        ``videos/traj_<step>/`` (and an mp4 beside them where an ``ffmpeg``
        binary is on the PATH). Returns the frames' directory."""
        c2ws = self.scene.camtoworlds
        if len(c2ws) > 10:
            c2ws = c2ws[5:-5]  # the ends are trimmed, as the reference does
        kind = self.cfg.render_traj_path
        if kind == "interp":
            path = traj_mod.generate_interpolated_path(
                c2ws, max(1, n_frames // max(len(c2ws) - 1, 1)))
        elif kind == "ellipse_z":
            path = traj_mod.generate_ellipse_path_z(c2ws, n_frames=n_frames)
        elif kind == "ellipse_y":
            path = traj_mod.generate_ellipse_path_y(c2ws, n_frames=n_frames)
        elif kind == "spiral":
            path = traj_mod.generate_spiral_path(c2ws, n_frames=n_frames)
        else:
            raise ValueError(f"unknown render_traj_path {kind!r}")
        out_dir = os.path.join(self.result_dir, "videos", f"traj_{step}")
        os.makedirs(out_dir, exist_ok=True)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        K = t(self.scene.Ks[len(self.scene.Ks) // 2])[None]
        image_id = torch.zeros((1,), dtype=torch.int64, device=self.device)
        for fi, c2w in enumerate(path):
            rgb, _, depth = self._eval_render(self.state, t(c2w)[None], K, image_id)
            if not self._primary:
                continue  # a mesh's other ranks render alongside (collectives)
            rgb = rgb[0].cpu().numpy()
            d = depth[0, ..., 0].cpu().numpy()
            lo, hi = np.percentile(d, 1), np.percentile(d, 99)
            dn = np.clip((d - lo) / max(hi - lo, 1e-6), 0, 1)
            frame = np.concatenate([rgb, np.repeat(dn[..., None], 3, axis=-1)], axis=1)
            Image.fromarray((frame * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"{fi:04d}.png"))
        if shutil.which("ffmpeg") and self._primary:
            mp4 = os.path.join(self.result_dir, "videos", f"traj_{step}.mp4")
            subprocess.run(
                ["ffmpeg", "-y", "-framerate", "30", "-i",
                 os.path.join(out_dir, "%04d.png"), "-pix_fmt", "yuv420p", mp4],
                check=False, capture_output=True)
        return out_dir

    def run_compression(self, step: int) -> Dict[str, float]:
        """PNG compression round trip: compress the alive splats under
        ``compression/``, decompress them into the capacity buffers and
        evaluate them as stage "compress"; the Trainer's state is left as
        it was. Under a mesh rank 0 compresses the gathered splats and every
        rank reads them back (one node's file system) into its shard."""
        out_dir = os.path.join(self.result_dir, "compression")
        host = {k: self._gather_rows(v).cpu().numpy() for k, v in self.state.params.items()}
        alive_host = self._gather_rows(self.state.alive).cpu().numpy()
        if self._primary:
            comp.compress(out_dir, host, alive_host)
        if self.mesh is not None:
            dist.barrier()
        params_np, _ = comp.decompress(out_dir)
        n = params_np["opacities"].shape[0]
        saved = self.state
        new_params = {}
        for k, v in host.items():
            buf = v.copy()
            buf[:n] = params_np[k]
            new_params[k] = self._rows(torch.as_tensor(buf, device=self.device))
        alive = self._rows(torch.arange(self.capacity, device=self.device) < n)
        self.state = self.state._replace(params=new_params, alive=alive)
        try:
            return self.eval(step, stage="compress")
        finally:
            self.state = saved

    # ------------------------------------------------------------------
    def render_view(self, camtoworld: np.ndarray, K: np.ndarray,
                    camera_model: str = None):
        """One view -> (rgb [H, W, 3], expected depth [H, W, 1]) as numpy;
        ``camera_model`` overrides the training model (the viewer's
        pinhole <-> spherical toggle)."""
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=self.device)[None]
        image_id = torch.zeros((1,), dtype=torch.int64, device=self.device)
        rgb, _, depth = self._eval_render(self.state, t(camtoworld), t(K), image_id,
                                          camera_model)
        return rgb[0].cpu().numpy(), depth[0].cpu().numpy()
