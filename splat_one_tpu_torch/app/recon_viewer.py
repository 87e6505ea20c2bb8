"""Live reconstruction viewer: the port of ``splat_one_tpu/app/recon_viewer.py``.

Point cloud + camera frusta in the browser while incremental SfM runs
(the reference's live PyQt/OpenGL window,
app/point_cloud_visualizer.py:195-224): a ThreadingHTTPServer serves one
self-contained canvas page that polls ``/state`` for the latest
registered cameras and triangulated points; ``LiveReconViewer.update`` is
the ``snapshot`` sink of ``sfm.reconstruct.incremental_reconstruct``
(host numpy poses and points). The rotations come from the port's
``sfm.ba._rodrigues`` on the CPU.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>reconstruction</title>
<style>body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;left:8px;top:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud"></div><script>
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let st={points:[],cams:[]},yaw=0.6,pitch=0.4,dist=6,cx=0,cy=0,cz=0;
function resize(){cv.width=innerWidth;cv.height=innerHeight}
addEventListener('resize',resize);resize();
let drag=null;cv.onmousedown=e=>drag=[e.clientX,e.clientY];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 yaw+=(e.clientX-drag[0])*0.01;pitch+=(e.clientY-drag[1])*0.01;
 pitch=Math.max(-1.5,Math.min(1.5,pitch));drag=[e.clientX,e.clientY]});
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001)});
function proj(p){
 const sx=Math.sin(yaw),cxw=Math.cos(yaw),sp=Math.sin(pitch),
   cp=Math.cos(pitch);
 let x=p[0]-cx,y=p[1]-cy,z=p[2]-cz;
 let x1=cxw*x+sx*z, z1=-sx*x+cxw*z;
 let y1=cp*y-sp*z1, z2=sp*y+cp*z1+dist;
 if(z2<0.05)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2, cv.height/2+f*y1/z2, z2];}
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 ctx.fillStyle='#9cf';
 for(const p of st.points){const q=proj(p);if(q)ctx.fillRect(q[0],q[1],2,2);}
 ctx.strokeStyle='#fa3';
 for(const c of st.cams){
  const o=proj(c[0]);if(!o)continue;
  for(let k=1;k<5;k++){const q=proj(c[k]);if(!q)continue;
   ctx.beginPath();ctx.moveTo(o[0],o[1]);ctx.lineTo(q[0],q[1]);ctx.stroke();}
 }
 document.getElementById('hud').textContent=
  st.cams.length+' cameras / '+st.points.length+' points';
 requestAnimationFrame(draw);}
draw();
async function poll(){try{
 const r=await fetch('/state');const s=await r.json();
 st=s;
 if(s.center){cx=s.center[0];cy=s.center[1];cz=s.center[2];}
}catch(e){}setTimeout(poll,700);}
poll();
</script></body></html>"""


def _frustum(R: np.ndarray, t: np.ndarray, scale: float):
    """Camera center + 4 frustum corner points in world space."""
    c = -R.T @ t
    corners = []
    for dx, dy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
        d = R.T @ np.array([dx * 0.5, dy * 0.35, 1.0])
        corners.append(c + d * scale)
    return [c.tolist()] + [p.tolist() for p in corners]


class LiveReconViewer:
    """Background HTTP server visualizing SfM progress."""

    def __init__(self, port: int = 8081, max_points: int = 20000):
        self.port = port
        self.max_points = max_points
        self._state = {"points": [], "cams": [], "center": [0, 0, 0]}
        self._lock = threading.Lock()
        self._httpd = None

    # ---- snapshot sink (incremental_reconstruct's `snapshot` arg) ------
    def update(self, poses: Dict[int, np.ndarray],
               points: Dict[int, np.ndarray]):
        import torch

        from splat_one_tpu_torch.sfm.ba import _rodrigues

        pts = np.array(list(points.values()), np.float32).reshape(-1, 3)
        if len(pts) > self.max_points:
            sel = np.linspace(0, len(pts) - 1, self.max_points).astype(int)
            pts = pts[sel]
        center = pts.mean(axis=0) if len(pts) else np.zeros(3)
        spread = (
            float(np.percentile(
                np.linalg.norm(pts - center, axis=1), 80
            )) if len(pts) else 1.0
        )
        cams = []
        for pose in poses.values():
            R = _rodrigues(torch.as_tensor(np.asarray(pose[:3], np.float32))).numpy()
            cams.append(_frustum(R, pose[3:], 0.12 * max(spread, 1e-3)))
        with self._lock:
            self._state = {
                "points": pts.tolist(),
                "cams": cams,
                "center": center.tolist(),
            }

    # ---- server --------------------------------------------------------
    def _make_handler(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path.startswith("/state"):
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    ctype = "application/json"
                else:
                    body = _PAGE.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        return Handler

    def serve_background(self):
        self._httpd = ThreadingHTTPServer(
            ("0.0.0.0", self.port), self._make_handler()
        )
        th = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        th.start()
        return f"http://localhost:{self.port}"

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd = None
