"""Interactive web viewer and the port's serving entry.

Counterpart of ``splat_one_tpu/app/viewer.py``. ``ViewerServer`` is the
same dependency-free HTTP server and page (WASD/QE fly-through, M toggles
pinhole <-> spherical); the browser sends camera state and the server
answers with a JPEG rendered on the GPU. ``make_render_fn`` builds the
render function it serves from a JAX-format checkpoint
(``load_checkpoint_params``): the computation of the JAX Trainer's
``_render_view_alt``, RGB+ED through ``rasterization()``.
"""

from __future__ import annotations

import io
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from splat_one_tpu_torch.core.transforms import invert_se3
from splat_one_tpu_torch.render.rasterization import rasterization
from splat_one_tpu_torch.utils.device import resolve as resolve_device

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

    def serve_forever(self):
        httpd = ThreadingHTTPServer(
            ("0.0.0.0", self.port), self._make_handler()
        )
        print(f"viewer on http://localhost:{self.port}")
        httpd.serve_forever()

    def serve_background(self):
        t = threading.Thread(target=self.serve_forever, daemon=True)
        t.start()
        return t


def params_from_numpy(np_params: dict, alive, device="cuda"):
    """The JAX package's splat parameters as numpy arrays (``means``,
    ``scales``, ``quats``, ``opacities``, ``sh0``/``shN`` or
    ``features``/``colors``) -> the port's ``(params, alive)`` tensors on
    ``device``: f32 parameters and a bool mask."""
    dev = resolve_device(device)
    params = {k: torch.as_tensor(np.asarray(v, np.float32), device=dev)
              for k, v in np_params.items()}
    return params, torch.as_tensor(np.asarray(alive, bool), device=dev)


def load_checkpoint_params(path: str, device="cuda"):
    """Read the splat parameters and ``alive`` mask of a JAX Trainer
    checkpoint (``ckpt_<step>.npz``, keys ``params['means']``, ... and
    ``alive``)."""
    with np.load(path) as z:
        np_params = {
            k.split("['")[1].rstrip("']"): z[k]
            for k in z.files if k.startswith("params[")
        }
        alive = z["alive"]
    if not np_params:
        raise ValueError(f"{path}: no params['...'] entries")
    return params_from_numpy(np_params, alive, device)


class Renderer:
    """Single-view renders of fixed splat parameters: the port's serving
    function. Calling it returns the uint8 image ``ViewerServer`` serves;
    ``render`` returns the float rgb and expected depth."""

    def __init__(self, params, alive, width, height, sh_degree=3,
                 camera_model="pinhole", device="cuda"):
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
        if "sh0" in p:
            self.colors = torch.cat([p["sh0"], p["shN"]], dim=1)
            self.sh_degree = sh_degree
        else:
            self.colors = torch.sigmoid(p["colors"])
            self.sh_degree = None

    @torch.inference_mode()
    def render(self, c2w, K, camera_model=None):
        """c2w [4, 4] and K [3, 3] (numpy or tensors) -> (rgb [H, W, 3],
        expected depth [H, W, 1], alpha [H, W, 1], info) on the device."""
        c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=self.device)
        K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
        out, alpha, info = rasterization(
            self.means, self.quats, self.scales, self.opacities, self.colors,
            invert_se3(c2w[None]), K[None], self.width, self.height,
            sh_degree=self.sh_degree,
            camera_model=camera_model or self.camera_model,
            render_mode="RGB+ED",
        )
        return out[0, ..., :3], out[0, ..., 3:], alpha[0], info

    def __call__(self, c2w, K, camera_model=None) -> np.ndarray:
        rgb = self.render(c2w, K, camera_model)[0]
        return (torch.clamp(rgb, 0, 1) * 255).to(torch.uint8).cpu().numpy()


def make_render_fn(params, alive, width, height, sh_degree=3,
                   camera_model="pinhole", device="cuda") -> Renderer:
    """The render function ``ViewerServer`` serves:
    ``fn(c2w, K, camera_model) -> uint8 [H, W, 3]``, with ``fn.render``
    for the float rgb, depth and alpha. Runs on CUDA unless ``device="cpu"``."""
    return Renderer(params, alive, width, height, sh_degree, camera_model,
                    device)
