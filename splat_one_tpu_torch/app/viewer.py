"""Interactive web viewer and the port's serving entry.

Counterpart of ``splat_one_tpu/app/viewer.py``. ``ViewerServer`` is the
same dependency-free HTTP server and page (WASD/QE fly-through, M toggles
pinhole <-> spherical); the browser sends camera state and the server
answers with a JPEG rendered on the GPU. ``make_render_fn`` builds the
render function it serves (``Renderer``) from a JAX-format checkpoint
(``load_checkpoint_params``, ``load_checkpoint_app_params``): the
computation of the JAX Trainer's ``_render_view_alt``, RGB+ED through
``rasterization()``. It serves 3DGS models with SH colour (``sh0`` /
``shN``), models trained with gsplat's appearance head (``Config.app_opt``:
``features`` / ``colors`` and the head's parameters, coloured by the
embedding of one training image, image 0 as ``Trainer.render_view``) and
models with plain colour logits (``colors`` alone); with
``primitive="2dgs"``, 2D Gaussian Splatting models (the same keys, the
rows drawn as surfels through ``rasterization_2dgs``).
``serve_workdir`` serves a workdir's latest checkpoint through a
``Trainer.render_view`` (``workdir_server`` builds that server), or a 2DGS
checkpoint through a ``Renderer``.
"""

from __future__ import annotations

import io
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from splat_one_tpu_torch.core.transforms import invert_se3
from splat_one_tpu_torch.data.opensfm import Parser, to_scene_data
from splat_one_tpu_torch.render.rasterization import rasterization, rasterization_2dgs
from splat_one_tpu_torch.train import appearance as APP
from splat_one_tpu_torch.train.config import Config
from splat_one_tpu_torch.train.trainer import Trainer
from splat_one_tpu_torch.utils.device import resolve as resolve_device
from splat_one_tpu_torch.utils.profiling import span

_PAGE = """<!DOCTYPE html>
<html><head><title>splat-one-tpu viewer</title>
<style>body{margin:0;background:#111;color:#eee;font-family:monospace}
#hud{position:fixed;top:8px;left:8px}</style></head>
<body>
<img id="view" width="{W}" height="{H}"/>
<div id="hud">WASD move / QE up-down / arrows rotate / M toggle camera</div>
<script>
let pos=[0,0,-3], yaw=0, pitch=0, model="pinhole", busy=false;
async function refresh(){
  if(busy) return; busy=true;
  try{
    const q=`/render?x=${pos[0]}&y=${pos[1]}&z=${pos[2]}&yaw=${yaw}&pitch=${pitch}&model=${model}`;
    const r=await fetch(q); const b=await r.blob();
    document.getElementById('view').src=URL.createObjectURL(b);
  } finally { busy=false; }
}
document.addEventListener('keydown',e=>{
  const s=0.15, r=0.08;
  const fwd=[Math.sin(yaw),0,Math.cos(yaw)];
  const right=[Math.cos(yaw),0,-Math.sin(yaw)];
  if(e.key=='w'){pos=pos.map((p,i)=>p+fwd[i]*s);}
  if(e.key=='s'){pos=pos.map((p,i)=>p-fwd[i]*s);}
  if(e.key=='a'){pos=pos.map((p,i)=>p-right[i]*s);}
  if(e.key=='d'){pos=pos.map((p,i)=>p+right[i]*s);}
  if(e.key=='q'){pos[1]-=s;} if(e.key=='e'){pos[1]+=s;}
  if(e.key=='ArrowLeft'){yaw-=r;} if(e.key=='ArrowRight'){yaw+=r;}
  if(e.key=='ArrowUp'){pitch-=r;} if(e.key=='ArrowDown'){pitch+=r;}
  if(e.key=='m'){model=model=='pinhole'?'spherical':'pinhole';}
  refresh();
});
refresh(); setInterval(refresh, 2000);
</script></body></html>"""


class ViewerServer:
    """Serves a render function at /render and the HTML page at /."""

    def __init__(self, render_fn, width=640, height=480, port=8080):
        # render_fn(c2w [4,4], K [3,3], camera_model) -> rgb uint8 [H,W,3]
        self.render_fn = render_fn
        self.width = width
        self.height = height
        self.port = port

    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    page = (
                        _PAGE.replace("{W}", str(server_self.width))
                        .replace("{H}", str(server_self.height))
                    )
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.end_headers()
                    self.wfile.write(page.encode())
                    return
                if u.path == "/render":
                    q = {
                        k: v[0] for k, v in parse_qs(u.query).items()
                    }
                    pos = np.array(
                        [float(q.get(k, 0)) for k in ("x", "y", "z")]
                    )
                    yaw = float(q.get("yaw", 0))
                    pitch = float(q.get("pitch", 0))
                    model = q.get("model", "pinhole")
                    cy, sy = np.cos(yaw), np.sin(yaw)
                    cp, sp = np.cos(pitch), np.sin(pitch)
                    R_yaw = np.array(
                        [[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]
                    )
                    R_pitch = np.array(
                        [[1, 0, 0], [0, cp, -sp], [0, sp, cp]]
                    )
                    c2w = np.eye(4, dtype=np.float32)
                    c2w[:3, :3] = R_yaw @ R_pitch
                    c2w[:3, 3] = pos
                    f = 0.5 * server_self.width  # 90 deg fov (reference
                    # nerfview CameraState fov=90, gsplat_manager.py:352)
                    K = np.array(
                        [
                            [f, 0, server_self.width / 2],
                            [0, f, server_self.height / 2],
                            [0, 0, 1],
                        ],
                        np.float32,
                    )
                    rgb = server_self.render_fn(c2w, K, model)
                    from PIL import Image

                    buf = io.BytesIO()
                    Image.fromarray(rgb).save(buf, format="JPEG",
                                              quality=90)
                    self.send_response(200)
                    self.send_header("Content-Type", "image/jpeg")
                    self.end_headers()
                    self.wfile.write(buf.getvalue())
                    return
                self.send_response(404)
                self.end_headers()

        return Handler

    def _bind(self):
        self.httpd = ThreadingHTTPServer(("0.0.0.0", self.port), self._make_handler())
        print(f"viewer on http://localhost:{self.port}", flush=True)
        return self.httpd

    def serve_forever(self):
        self._bind().serve_forever()

    def serve_background(self):
        """Bind now and serve from a daemon thread; ``shutdown`` stops it."""
        t = threading.Thread(target=self._bind().serve_forever, daemon=True)
        t.start()
        return t

    def shutdown(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def params_from_numpy(np_params: dict, alive, device="cuda"):
    """The JAX package's splat parameters as numpy arrays (``means``,
    ``scales``, ``quats``, ``opacities``, ``sh0``/``shN`` or
    ``features``/``colors``) -> the port's ``(params, alive)`` tensors on
    ``device``: f32 parameters and a bool mask."""
    dev = resolve_device(device)
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in np_params.items()}
    return params, torch.as_tensor(np.asarray(alive, bool), device=dev)


def _entries(z, prefix: str) -> dict:
    """The npz entries ``<prefix>['<name>']`` as {name: array}."""
    return {k.split("['")[1].rstrip("']"): z[k]
            for k in z.files if k.startswith(prefix + "[")}


def load_checkpoint_params(path: str, device="cuda"):
    """Read the splat parameters and ``alive`` mask of a JAX Trainer
    checkpoint (``ckpt_<step>.npz``, keys ``params['means']``, ... and
    ``alive``)."""
    with np.load(path) as z:
        np_params = _entries(z, "params")
        alive = z["alive"]
    if not np_params:
        raise ValueError(f"{path}: no params['...'] entries")
    return params_from_numpy(np_params, alive, device)


def load_checkpoint_app_params(path: str, device="cuda"):
    """The appearance head's parameters of a checkpoint trained with
    ``app_opt`` (keys ``app['embeds']``, ``app['w0']``, ...) as f32
    tensors on ``device``, or None where it holds none."""
    with np.load(path) as z:
        np_app = _entries(z, "app")
    if not np_app:
        return None
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
            for k, v in np_app.items()}


class Renderer:
    """Single-view renders of fixed splat parameters: the port's serving
    function. Calling it returns the uint8 image ``ViewerServer`` serves;
    ``render`` returns the float rgb and expected depth. A call is the
    span ``viewer.request`` (``utils.profiling``), with ``viewer.inputs``,
    ``viewer.appearance`` (appearance models), ``rasterization``'s spans and
    ``viewer.frame`` inside.

    The models it serves, by their parameters:

    - ``sh0`` / ``shN``: 3DGS's SH colour of degree ``sh_degree``,
      evaluated by the projection;
    - ``features`` / ``colors`` with ``app_params`` (a Trainer's
      ``app_opt``, gsplat's ``--app_opt``): per request, gsplat's colour
      ``sigmoid(colors + head(embedding, features, SH basis of the
      direction from the camera centre))`` over every row
      (``train.appearance.appearance_rgb_from_centres``), with the
      embedding of training image 0 (as ``Trainer.render_view``) and the
      SH basis of degree ``sh_degree`` (the Trainer's
      ``Config.sh_degree``). On CUDA one kernel evaluates it
      (``csrc/appearance_fwd.cu``): heads of hidden width 64 with two or
      three linear layers (the Trainer's default, gsplat's
      ``mlp_depth=2``), features of a width divisible by 4 and inputs of
      at most 128; any other head raises ``ValueError`` there. On the CPU
      the plain head serves a head of any width and depth. Without
      ``app_params``, or with no embedding row for image 0, such a model
      is refused: ``sigmoid(colors)`` alone is not its colour;
    - ``colors`` alone: ``sigmoid(colors)``.

    ``primitive="2dgs"`` draws the rows as 2D Gaussian Splatting's surfels
    (``rasterization_2dgs``: the first two scale columns, the rotation's
    first two axes; SH models, pinhole cameras; forward only) in place of
    3D gaussians (``"3dgs"``)."""

    def __init__(self, params, alive, width, height, sh_degree=3,
                 camera_model="pinhole", device="cuda", app_params=None, primitive="3dgs"):
        if primitive not in ("3dgs", "2dgs"):
            raise ValueError(f"unknown primitive {primitive!r}")
        if primitive == "2dgs" and "sh0" not in params:
            raise ValueError("2DGS is served for models with SH colour (sh0 / shN)")
        self.primitive = primitive
        self.device = resolve_device(device)
        p = {k: v.to(self.device) for k, v in params.items()}
        alive = alive.to(self.device)
        self.width, self.height = width, height
        self.camera_model = camera_model
        self.means = p["means"]
        self.quats = p["quats"]
        self.scales = torch.exp(p["scales"])
        self.opacities = torch.where(alive, torch.sigmoid(p["opacities"]),
                                     torch.zeros_like(p["opacities"]))
        self.app_params = None
        if "sh0" in p:
            self.colors = torch.cat([p["sh0"], p["shN"]], dim=1)
            self.sh_degree = sh_degree
        elif "features" in p:
            if app_params is None:
                raise ValueError("a model with features / colors is coloured by its "
                                 "appearance head: pass app_params "
                                 "(load_checkpoint_app_params reads a checkpoint's)")
            if app_params["embeds"].dim() != 2 or app_params["embeds"].shape[0] < 1:
                raise ValueError("the head serves image 0's embedding: embeds must be "
                                 f"[n_images >= 1, E], got {tuple(app_params['embeds'].shape)}")
            self.app_params = {k: v.to(self.device) for k, v in app_params.items()}
            self.features = p["features"]
            self.color_logits = p["colors"]
            self.image_ids = torch.zeros(1, dtype=torch.long, device=self.device)
            self.app_degree = sh_degree
            self.sh_degree = None
        else:
            self.colors = torch.sigmoid(p["colors"])
            self.sh_degree = None

    @torch.inference_mode()
    def render(self, c2w, K, camera_model=None):
        """c2w [4, 4] and K [3, 3] (numpy or tensors) -> (rgb [H, W, 3],
        expected depth [H, W, 1], alpha [H, W, 1], info) on the device."""
        with span("viewer.inputs"):
            c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=self.device)
            K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
            viewmats = invert_se3(c2w[None])
        if self.app_params is None:
            colors = self.colors
        else:
            with span("viewer.appearance"):
                colors = APP.appearance_rgb_from_centres(
                    self.app_params, self.features, self.color_logits, self.image_ids,
                    self.means, c2w[None, :3, 3], self.app_degree)
        raster = rasterization_2dgs if self.primitive == "2dgs" else rasterization
        out, alpha, info = raster(
            self.means, self.quats, self.scales, self.opacities, colors,
            viewmats, K[None], self.width, self.height,
            sh_degree=self.sh_degree,
            camera_model=camera_model or self.camera_model,
            render_mode="RGB+ED",
        )
        return out[0, ..., :3], out[0, ..., 3:], alpha[0], info

    def __call__(self, c2w, K, camera_model=None) -> np.ndarray:
        with span("viewer.request"):
            rgb = self.render(c2w, K, camera_model)[0]
            with span("viewer.frame"):
                return (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def make_render_fn(params, alive, width, height, sh_degree=3,
                   camera_model="pinhole", device="cuda", app_params=None,
                   primitive="3dgs") -> Renderer:
    """The render function ``ViewerServer`` serves:
    ``fn(c2w, K, camera_model) -> uint8 [H, W, 3]``, with ``fn.render``
    for the float rgb, depth and alpha; ``app_params`` and ``primitive``
    as ``Renderer`` takes them. Runs on CUDA unless ``device="cpu"``."""
    return Renderer(params, alive, width, height, sh_degree, camera_model,
                    device, app_params, primitive)


def latest_checkpoint(workdir: str):
    """The highest-step ``ckpt_<step>.npz`` under ``<workdir>/results/ckpts``
    (by step number, not name), or None."""
    ckpt_dir = os.path.join(workdir, "results", "ckpts")
    if not os.path.isdir(ckpt_dir):
        return None
    cands = [(int(m.group(1)), f) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"ckpt_(\d+).*\.npz$", f))]
    return os.path.join(ckpt_dir, max(cands)[1]) if cands else None


def workdir_server(workdir: str, port: int = 8080, ckpt: str = None,
                   device="cuda", primitive="3dgs") -> ViewerServer:
    """A ``ViewerServer`` for the workdir: a Trainer over its first two
    images (for the size and camera model) loads ``ckpt`` or the latest
    checkpoint and renders each request through ``render_view``. The
    server's page and camera are 640x480; the render has the images'
    size, as in the JAX package. With ``primitive="2dgs"`` the checkpoint
    (``ckpt`` or the latest; a 3DGS checkpoint's keys, the rows drawn as
    surfels) is served by a ``Renderer`` at the page's size, pinhole
    whatever the page's camera toggle asks. Runs on CUDA unless
    ``device="cpu"``."""
    dev = resolve_device(device)
    if primitive == "2dgs":
        ckpt = ckpt or latest_checkpoint(workdir)
        if not ckpt:
            raise ValueError(f"{workdir}: no checkpoint to serve as 2DGS")
        params, alive = load_checkpoint_params(ckpt, dev)
        sh_degree = int(round((1 + params["shN"].shape[1]) ** 0.5)) - 1 if "shN" in params \
            else 3
        rd = Renderer(params, alive, 640, 480, sh_degree, device=dev, primitive="2dgs")
        return ViewerServer(lambda c2w, K, model: rd(c2w, K, "pinhole"), port=port)
    scene = to_scene_data(Parser(workdir), max_images=2)
    cfg = Config(result_dir=os.path.join(workdir, "results"),
                 camera_model=scene.camera_model)
    tr = Trainer(cfg, scene, device=dev)
    ckpt = ckpt or latest_checkpoint(workdir)
    if ckpt:
        tr.load_checkpoint(ckpt)

    def render_fn(c2w, K, model):
        rgb, _ = tr.render_view(c2w, K, camera_model=model)
        return (np.clip(rgb, 0, 1) * 255).astype(np.uint8)

    return ViewerServer(render_fn, port=port)


def serve_workdir(workdir: str, port: int = 8080, ckpt: str = None, device="cuda",
                  primitive="3dgs"):
    """Serve the workdir's latest checkpoint (or ``ckpt``) until killed."""
    workdir_server(workdir, port, ckpt, device, primitive).serve_forever()
