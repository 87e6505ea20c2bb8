"""Interactive point-prompt masking UI over HTTP: the port of
``splat_one_tpu/app/mask_ui.py``.

The web equivalent of the reference's masks tab (app/mask_manager.py:
click handling :226-231, predictor call :235-243, inverted mask save
:245-248): click = positive point, shift+click = negative, a live mask
preview from ``models.segmentation.build_predictor`` (SAM 2.1 or the
compact net on ``device``, CUDA unless ``device="cpu"``; the classical
region grower without a checkpoint), save writes ``masks/<img>.png`` in
the OpenSfM 0=ignore convention plus ``masks_clicks.json``, which the
batch ``create-masks`` stage replays headlessly. Requests run on the
server's threads; one lock serialises ``set_image`` / ``predict``, and
the predictor puts every tensor on its own device.
"""

from __future__ import annotations

import io
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><title>splat-one-tpu masks</title>
<style>
body{margin:0;background:#111;color:#eee;font-family:monospace}
#bar{padding:6px}
#wrap{position:relative;display:inline-block}
#img,#ovl{display:block;max-width:96vw}
#ovl{position:absolute;left:0;top:0;pointer-events:none;opacity:.55}
select,button{background:#222;color:#eee;border:1px solid #555;margin-right:6px}
</style></head>
<body>
<div id="bar">
<select id="sel"></select>
<button onclick="clearPts()">clear</button>
<button onclick="undo()">undo</button>
<button onclick="save()">save mask</button>
<span id="msg">click = object (+), shift+click = background (-)</span>
</div>
<div id="wrap"><img id="img"/><canvas id="ovl"></canvas></div>
<script>
let pts=[], labels=[], name=null, busy=false;
const sel=document.getElementById('sel'), img=document.getElementById('img'),
      ovl=document.getElementById('ovl'), msg=document.getElementById('msg');
async function init(){
  const names=await (await fetch('/images')).json();
  for(const n of names){const o=document.createElement('option');o.text=n;sel.add(o);}
  sel.onchange=()=>load(sel.value);
  if(names.length) load(names[0]);
}
function load(n){
  name=n; pts=[]; labels=[];
  img.src='/image?name='+encodeURIComponent(n);
  img.onload=()=>{ovl.width=img.naturalWidth;ovl.height=img.naturalHeight;
    ovl.style.width=img.clientWidth+'px';ovl.style.height=img.clientHeight+'px';
    drawPts();};
}
img_scale=()=>[img.naturalWidth/img.clientWidth, img.naturalHeight/img.clientHeight];
document.getElementById('img').onclick=async e=>{
  const r=img.getBoundingClientRect(), s=img_scale();
  pts.push([(e.clientX-r.left)*s[0], (e.clientY-r.top)*s[1]]);
  labels.push(e.shiftKey?0:1);
  await predict();
};
function drawPts(){
  const c=ovl.getContext('2d');
  for(let i=0;i<pts.length;i++){
    c.fillStyle=labels[i]? '#0f0':'#f00';
    c.beginPath(); c.arc(pts[i][0],pts[i][1],5,0,7); c.fill();
  }
}
async function predict(){
  if(busy||!pts.length) return; busy=true; msg.textContent='predicting...';
  try{
    const r=await fetch('/predict',{method:'POST',
      body:JSON.stringify({name:name,points:pts,labels:labels})});
    const b=await r.blob();
    const url=URL.createObjectURL(b);
    const m=new Image();
    m.onload=()=>{const c=ovl.getContext('2d');
      c.clearRect(0,0,ovl.width,ovl.height); c.drawImage(m,0,0); drawPts();
      msg.textContent=pts.length+' points'; busy=false;};
    m.onerror=()=>{msg.textContent='predict failed'; busy=false;};
    m.src=url;
  } catch(e){ msg.textContent='predict failed'; busy=false; }
}
async function save(){
  if(!pts.length) return;
  await fetch('/save',{method:'POST',
    body:JSON.stringify({name:name,points:pts,labels:labels})});
  msg.textContent='saved masks/'+name+'.png';
}
function clearPts(){pts=[];labels=[];
  ovl.getContext('2d').clearRect(0,0,ovl.width,ovl.height);}
function undo(){pts.pop();labels.pop();
  ovl.getContext('2d').clearRect(0,0,ovl.width,ovl.height);
  if(pts.length) predict(); else drawPts();}
init();
</script></body></html>"""


class MaskUIServer:
    """Point-prompt masking over a workdir's ``images/``."""

    def __init__(self, workdir: str, checkpoint: str = None,
                 port: int = 8081, device="cuda"):
        from splat_one_tpu_torch.models.segmentation import build_predictor
        from splat_one_tpu_torch.utils.device import resolve

        self.workdir = workdir
        self.port = port
        self.predictor = build_predictor(checkpoint, device=resolve(device))
        self._cur_name = None
        self._lock = threading.Lock()
        self.httpd = ThreadingHTTPServer(
            ("0.0.0.0", port), self._make_handler()
        )

    # -- predictor plumbing ------------------------------------------------
    def _image(self, name: str) -> np.ndarray:
        from PIL import Image

        path = os.path.join(self.workdir, "images", name)
        return np.asarray(Image.open(path).convert("RGB"))

    def _mask_for(self, name: str, points, labels) -> np.ndarray:
        with self._lock:
            if self._cur_name != name:
                self.predictor.set_image(self._image(name))
                self._cur_name = name
            masks, scores, _ = self.predictor.predict(
                np.asarray(points, np.float32),
                np.asarray(labels, np.int32),
            )
        # multimask predictors return candidates in token order — take
        # the highest-scoring one (reference mask_manager.py flow)
        best = int(np.argmax(np.asarray(scores)))
        return np.asarray(masks[best]) > 0.5

    def _save(self, name: str, points, labels) -> None:
        from splat_one_tpu_torch.models.segmentation import save_mask

        mask = self._mask_for(name, points, labels)
        out = os.path.join(self.workdir, "masks", name + ".png")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        # inverted: clicked object = 0 = ignored by SfM (OpenSfM
        # convention; reference app/mask_manager.py:245-248)
        save_mask(mask, out, invert=True)
        clicks_path = os.path.join(self.workdir, "masks_clicks.json")
        clicks = {}
        if os.path.exists(clicks_path):
            with open(clicks_path) as f:
                clicks = json.load(f)
        clicks[name] = {"points": [list(map(float, p)) for p in points],
                        "labels": [int(x) for x in labels]}
        with open(clicks_path, "w") as f:
            json.dump(clicks, f, indent=1)

    def _overlay_png(self, mask: np.ndarray) -> bytes:
        from PIL import Image

        h, w = mask.shape
        rgba = np.zeros((h, w, 4), np.uint8)
        rgba[..., 1] = 255  # green
        rgba[..., 3] = np.where(mask, 200, 0).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(rgba).save(buf, "PNG")
        return buf.getvalue()

    # -- http --------------------------------------------------------------
    def _make_handler(server_self):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="text/html"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, _PAGE.encode())
                elif self.path == "/images":
                    d = os.path.join(server_self.workdir, "images")
                    names = sorted(
                        f for f in os.listdir(d)
                        if f.lower().split(".")[-1] in
                        ("jpg", "jpeg", "png")
                    ) if os.path.isdir(d) else []
                    self._send(200, json.dumps(names).encode(),
                               "application/json")
                elif self.path.startswith("/image?"):
                    from urllib.parse import parse_qs, urlparse

                    q = parse_qs(urlparse(self.path).query)
                    name = os.path.basename(q["name"][0])
                    p = os.path.join(server_self.workdir, "images", name)
                    if not os.path.exists(p):
                        self._send(404, b"missing")
                        return
                    with open(p, "rb") as f:
                        self._send(200, f.read(), "image/jpeg")
                else:
                    self._send(404, b"not found")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                spec = json.loads(self.rfile.read(n))
                name = os.path.basename(spec["name"])
                if self.path == "/predict":
                    mask = server_self._mask_for(
                        name, spec["points"], spec["labels"])
                    self._send(200, server_self._overlay_png(mask),
                               "image/png")
                elif self.path == "/save":
                    server_self._save(name, spec["points"], spec["labels"])
                    self._send(200, b"{}", "application/json")
                else:
                    self._send(404, b"not found")

        return Handler

    def serve_forever(self):
        print(f"mask UI at http://localhost:{self.port}/")
        self.httpd.serve_forever()

    def serve_background(self):
        t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        t.start()
        return t
