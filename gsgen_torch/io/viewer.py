"""Interactive web viewer for trained scenes.

Port of the JAX package's ``io/viewer.py`` (which replaces the reference's
viser viewer, utils/viewer/viser_viewer.py:26-188 + vis.py in
gsgen3d/gsgen): a dependency-free stdlib HTTP server with a small HTML
page of orbit controls that requests
``/render?azimuth=..&elevation=..&distance=..&reso=..``; the backend
renders through the normal ``render_view`` path on the device of the
scene (the card, for a trainer built there), one render at a time under
a lock.  Images are JPEG where PIL imports, as in the JAX package, and
PNG through the port's own encoder (:func:`..io.logging.encode_png`)
where it does not; the response's ``Content-Type`` says which, and the
page's ``<img>`` shows either.  ``/stats`` gives the live Gaussian count
and the attached training step.
"""

from __future__ import annotations

import io
import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data.cameras import c2w_from_up_and_look_at
from ..models.scene import RenderConfig, SceneState, render_view
from ..ops.camera import CameraIntrinsics
from .logging import encode_png

PAGE = """<!DOCTYPE html><html><head><title>gsgen-torch viewer</title><style>
body{background:#111;color:#eee;font-family:sans-serif;margin:1em}
img{image-rendering:auto;border:1px solid #333;cursor:grab;touch-action:none}
label{margin-right:.8em;font-size:13px}#fps{color:#7c7}</style></head><body>
<h3>gsgen-torch viewer <span id=fps></span></h3>
<div><label>reso <select id=re><option>128</option><option selected>256</option>
<option>512</option></select></label>
<label>fov <input id=fov type=range min=20 max=120 value=53></label>
<label>near <input id=near type=range min=1 max=100 value=1></label>
<label>far <input id=far type=range min=5 max=1000 value=1000></label>
<label><input id=rot type=checkbox checked>auto-rotate</label>
<span style=color:#888>drag: orbit &middot; right-drag / shift-drag: pan
&middot; wheel: zoom</span></div>
<p><img id=v width=512 height=512></p>
<script>
const q=id=>document.getElementById(id);
let az=0,el=20,di=2.5,cx=0,cy=0,cz=0,busy=false,t0=0;
async function refresh(){if(busy)return;busy=true;t0=performance.now();
 const u=`/render?azimuth=${az}&elevation=${el}&distance=${di}`+
  `&reso=${q('re').value}&fov=${q('fov').value}`+
  `&near=${q('near').value/100}&far=${q('far').value}`+
  `&cx=${cx}&cy=${cy}&cz=${cz}`;
 const r=await fetch(u);const b=await r.blob();
 q('v').src=URL.createObjectURL(b);
 q('fps').textContent=(1000/(performance.now()-t0)).toFixed(1)+' fps';
 busy=false}
setInterval(()=>{if(q('rot').checked){az=(az+543)%360-180}refresh()},150);
for(const id of['re','fov','near','far'])q(id).oninput=refresh;
const img=q('v');let drag=null;
img.onpointerdown=e=>{drag=[e.clientX,e.clientY,e.button===2||e.shiftKey];
 img.setPointerCapture(e.pointerId);e.preventDefault()};
img.oncontextmenu=e=>e.preventDefault();
img.onpointermove=e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];drag[0]=e.clientX;drag[1]=e.clientY;
 if(drag[2]){const a=az*Math.PI/180,s=di*0.002;
  cx+=s*(dx*Math.sin(a));cy+=s*(-dx*Math.cos(a));cz+=s*dy;}
 else{az=((az-dx*0.4+180)%360+360)%360-180;
  el=Math.max(-89,Math.min(89,el+dy*0.4));}
 q('rot').checked=false;refresh()};
img.onpointerup=()=>{drag=null};
img.onwheel=e=>{di=Math.max(0.3,Math.min(12,di*(1+e.deltaY*0.001)));
 e.preventDefault();refresh()};
refresh();
</script></body></html>"""

def _jpeg_encoder():
    """An ``img uint8 [H, W, 3] -> JPEG bytes`` function where PIL
    imports, else None."""
    try:
        from PIL import Image
    except ImportError:
        return None

    def encode(img: np.ndarray) -> bytes:
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, "JPEG", quality=90)
        return buf.getvalue()

    return encode


class SceneViewer:
    """Multi-client by construction: camera state lives in each
    browser's JS (every request carries its full pose), the HTTP layer
    is a ThreadingHTTPServer, and the one shared resource, the device,
    is guarded by ``_render_lock`` so concurrent clients serialize
    instead of interleaving launches (the viser viewer's per-client
    render loop, utils/viewer/viser_viewer.py:132-171, serializes on the
    GPU the same way).  ``port=0`` binds a free port; :meth:`serve` sets
    ``port`` to the bound one."""

    def __init__(self, state: SceneState, rcfg: RenderConfig,
                 port: int = 8090):
        self.state = state
        self.rcfg = rcfg
        self.port = port
        self.step = None
        self._render_lock = threading.Lock()
        self._jpeg = _jpeg_encoder()
        self.content_type = "image/jpeg" if self._jpeg else "image/png"

    def update_state(self, state: SceneState, step=None):
        """Attach live training state (called between trainer steps:
        clients see the scene evolve, the viser pattern)."""
        self.state = state
        if step is not None:
            self.step = int(step)

    def render(self, azimuth, elevation, distance, reso,
               fov=53.13, near=0.01, far=1000.0,
               center=(0.0, 0.0, 0.0)) -> bytes:
        """Free camera: orbit pose around a pannable center with
        client-driven fov/near/far (reference utils/viewer/
        viser_viewer.py:26-188 GUI controls); JPEG or PNG bytes, as
        ``content_type`` says."""
        ar, er = math.radians(azimuth), math.radians(elevation)
        center = np.asarray(center, np.float64)
        pos = center + np.array([distance * math.cos(er) * math.cos(ar),
                                 distance * math.cos(er) * math.sin(ar),
                                 distance * math.sin(er)])
        c2w = c2w_from_up_and_look_at(np.array([0.0, 0.0, 1.0]), center,
                                      pos)
        intr = CameraIntrinsics.from_fov(
            math.radians(float(fov)), 1.0, int(reso),
            near=float(near), far=float(far))
        with self._render_lock, torch.no_grad():
            state = self.state
            dev = state.params["mean"].device
            out = render_view(state.params, state.active,
                              torch.as_tensor(c2w, device=dev), intr,
                              self.rcfg, torch.zeros(3, device=dev))
            img = torch.clamp(out["rgb"], 0, 1).cpu().numpy()
        u8 = (img * 255).astype(np.uint8)
        return self._jpeg(u8) if self._jpeg else encode_png(u8)

    def serve(self, blocking: bool = True):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                elif u.path == "/render":
                    q = {k: v[0] for k, v in parse_qs(u.query).items()}
                    body = viewer.render(
                        float(q.get("azimuth", 0)),
                        float(q.get("elevation", 20)),
                        float(q.get("distance", 2.5)),
                        int(q.get("reso", 256)),
                        fov=float(q.get("fov", 53.13)),
                        near=float(q.get("near", 0.01)),
                        far=float(q.get("far", 1000.0)),
                        center=(float(q.get("cx", 0)),
                                float(q.get("cy", 0)),
                                float(q.get("cz", 0))))
                    self.send_response(200)
                    self.send_header("Content-Type", viewer.content_type)
                elif u.path == "/stats":
                    body = json.dumps({
                        "num_gaussians": int(viewer.state.active.sum()),
                        "step": viewer.step}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                else:
                    self.send_response(404)
                    body = b""
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self.httpd.server_address[1]
        print(f"viewer at http://localhost:{self.port}/", flush=True)
        if blocking:
            self.httpd.serve_forever()
        else:
            t = threading.Thread(target=self.httpd.serve_forever, daemon=True)
            t.start()
            return t
