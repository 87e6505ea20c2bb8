"""Training configuration: counterpart of ``splat_one_tpu/train/config.py``,
field for field (the reference trainer's ``Config`` surface plus the
capacity knobs). ``adjust_steps`` scales every step count by
``steps_scaler``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Literal, Optional, Tuple, Union

from splat_one_tpu_torch.train.strategy import DefaultStrategyCfg, MCMCStrategyCfg


@dataclasses.dataclass
class Config:
    # evaluation-only checkpoint loading
    ckpt: Optional[List[str]] = None
    # compression strategy ("png" round-trip eval)
    compression: Optional[str] = None
    # render trajectory path type (interp | ellipse_z | ellipse_y | spiral)
    render_traj_path: str = "interp"

    data_dir: str = "data_dir"
    data_factor: int = 4
    result_dir: str = "results/"
    test_every: int = 8
    patch_size: Optional[int] = None
    global_scale: float = 1.0
    normalize_world_space: bool = True
    camera_model: Literal["pinhole", "ortho", "fisheye", "spherical"] = (
        "spherical"
    )

    batch_size: int = 1
    steps_scaler: float = 1.0

    max_steps: int = 30_000
    eval_steps: List[int] = dataclasses.field(
        default_factory=lambda: [7_000, 30_000]
    )
    save_steps: List[int] = dataclasses.field(
        default_factory=lambda: [7_000, 30_000]
    )

    init_type: str = "sfm"
    init_num_pts: int = 100_000
    init_extent: float = 3.0
    sh_degree: int = 3
    sh_degree_interval: int = 1000
    init_opa: float = 0.1
    init_scale: float = 1.0
    ssim_lambda: float = 0.2

    near_plane: float = 0.01
    far_plane: float = 1e8

    strategy: Union[DefaultStrategyCfg, MCMCStrategyCfg] = dataclasses.field(
        default_factory=DefaultStrategyCfg
    )
    # gsplat packed/sparse-grad modes: the capacity layout is always
    # "packed"; flags kept for config parity.
    packed: bool = False
    sparse_grad: bool = False
    visible_adam: bool = False
    antialiased: bool = False

    random_bkgd: bool = False

    opacity_reg: float = 0.0
    scale_reg: float = 0.0

    pose_opt: bool = False
    pose_opt_lr: float = 1e-5
    pose_opt_reg: float = 1e-6
    pose_noise: float = 0.0

    app_opt: bool = False
    app_embed_dim: int = 16
    app_opt_lr: float = 1e-3
    app_opt_reg: float = 1e-6

    use_bilateral_grid: bool = False
    bilateral_grid_shape: Tuple[int, int, int] = (16, 16, 8)

    depth_loss: bool = False
    depth_lambda: float = 1e-2

    tb_every: int = 100
    tb_save_image: bool = False

    lpips_net: str = "alex"

    # ---- capacity and rasterizer ----
    # splat buffer capacity; 0 = auto (next power of two with headroom)
    capacity: int = 0
    capacity_headroom: float = 4.0
    tile_size: int = 16
    # intersection capacity as avg tiles per gaussian (tiled exp_cap sizing)
    avg_tiles_per_gaussian: float = 8.0
    # rasterizer backend: "stream" (supertile stream) or "tiled"
    raster_impl: str = "stream"
    # stream-impl exp_cap sizing: avg supertiles per gaussian
    avg_supertiles_per_gaussian: float = 4.0
    # multi-device exchange of projected fields ("ring" | "all_gather"), as
    # the JAX Config names it; the port takes one all_gather for both
    gauss_exchange: str = "ring"
    seed: int = 42

    def adjust_steps(self, factor: Optional[float] = None) -> "Config":
        f = self.steps_scaler if factor is None else factor
        if f == 1.0:
            return self
        strat = self.strategy
        strat = dataclasses.replace(
            strat,
            refine_start_iter=int(strat.refine_start_iter * f),
            refine_stop_iter=int(strat.refine_stop_iter * f),
            refine_every=int(strat.refine_every * f),
            **(
                {"reset_every": int(strat.reset_every * f)}
                if isinstance(strat, DefaultStrategyCfg)
                else {}
            ),
        )
        return dataclasses.replace(
            self,
            max_steps=int(self.max_steps * f),
            eval_steps=[int(s * f) for s in self.eval_steps],
            save_steps=[int(s * f) for s in self.save_steps],
            sh_degree_interval=int(self.sh_degree_interval * f),
            strategy=strat,
        )
