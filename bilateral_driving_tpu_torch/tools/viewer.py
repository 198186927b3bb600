"""Live viewer: port of bilateral_driving_tpu/tools/viewer.py, a stdlib HTTP
server in a daemon thread.

Counterpart of the reference's viser/nerfview viewer
(project/models/trainers/base.py:755-827). It serves an orbit-controls
page (`/`), frames rendered on demand through the trainer's novel-view
forward (`/frame?eye=x,y,z&look=x,y,z&t=T`, camera refinement off,
base.py:325-329), the training loop's stats (`/stats`) and a pause toggle
(`POST /pause`). Frames are PNG from utils/visualization.png_bytes (the
card has no PIL; the JAX package sends JPEG, and the page shows either).
A render holds `Viewer.lock`; the training CLI holds it around each step
window, so a frame and a step never run at once on the card (the
reference's viewer_lock).

Attached to training: `tools.train --viewer_port PORT`. Stand-alone, on a
run directory's config.json and latest checkpoint:

    python -m bilateral_driving_tpu_torch.tools.viewer --log_dir RUN \
        [--checkpoint PATH] [--port 8080] [--device cpu] [key=value ...]
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from ..utils import visualization

_PAGE = """<!doctype html><html><head><title>bilateral_driving_tpu_torch</title>
<style>body{margin:0;background:#111;color:#ccc;font:13px monospace}
#hud{position:fixed;top:8px;left:8px}
#stats{position:fixed;top:8px;right:8px;text-align:right}
#pause{cursor:pointer;border:1px solid #888;padding:2px 8px}</style></head>
<body><canvas id=c></canvas><div id=hud>drag: orbit &middot; wheel: dolly
&middot; shift-drag: pan &middot; [ ] : time</div>
<div id=stats><span id=tr></span> <span id=pause>pause</span></div><script>
const c=document.getElementById('c'),x=c.getContext('2d');
let az=0,el=0.2,r=12,cx=0,cy=0,cz=0,t=0,busy=false,dirty=true;
c.width=innerWidth;c.height=innerHeight;
const pb=document.getElementById('pause'),tr=document.getElementById('tr');
pb.onclick=async()=>{const r=await fetch('/pause',{method:'POST'});
 const j=await r.json();pb.textContent=j.paused?'resume':'pause';};
setInterval(async()=>{try{const r=await fetch('/stats');const j=await
 r.json();tr.textContent=`step ${j.step} | ${j.steps_per_s.toFixed(2)} it/s`+
 ` | ${j.num_points} pts | loss ${j.loss.toFixed(4)}`;
 pb.textContent=j.paused?'resume':'pause';}catch(e){}},1000);
function pose(){
 const ce=Math.cos(el),se=Math.sin(el),ca=Math.cos(az),sa=Math.sin(az);
 const eye=[cx+r*ce*sa,cy+r*ce*ca,cz+r*se];
 return {eye:eye,look:[cx,cy,cz],t:t};}
async function draw(){
 if(busy||!dirty)return;busy=true;dirty=false;
 const p=pose();
 const q=`/frame?eye=${p.eye}&look=${p.look}&t=${p.t}`;
 const img=new Image();
 img.onload=()=>{x.drawImage(img,0,0,c.width,c.height);busy=false;};
 img.onerror=()=>{busy=false;};
 img.src=q+'&_='+Date.now();}
setInterval(draw,100);
let mx=0,my=0,drag=false,pan=false;
c.onmousedown=e=>{drag=true;pan=e.shiftKey;mx=e.clientX;my=e.clientY};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-mx,dy=e.clientY-my;mx=e.clientX;my=e.clientY;
 if(pan){cx-=dx*0.02;cz+=dy*0.02}else{az+=dx*0.005;el+=dy*0.005}
 dirty=true};
c.onwheel=e=>{r*=Math.exp(e.deltaY*0.001);dirty=true;e.preventDefault()};
window.onkeydown=e=>{if(e.key==='[')t=Math.max(0,t-0.05);
 if(e.key===']')t=Math.min(1,t+0.05);dirty=true};
</script></body></html>"""


def _look_at(eye, look, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """OpenCV-convention camera-to-world (x right, y down, z forward) of a
    camera at `eye` looking at `look`."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(look, np.float64) - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right = right / max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, down, fwd, eye
    return m


class Viewer:
    """Serve `render_fn(c2w (4, 4) numpy, t float) -> (H, W, 3) float in
    [0, 1]` (numpy or a tensor).

    Training-mode extras (nerfview "training", base.py:755-762):
    `update_stats(step=..., steps_per_s=..., ...)` feeds the page's
    readout, and the page's pause button toggles `paused`, which an
    attached training loop honours through `wait_if_paused()`."""

    def __init__(self, render_fn: Callable, port: int = 8080,
                 host: str = "127.0.0.1"):
        self.render_fn = render_fn
        self.paused = False
        self.lock = threading.Lock()
        self.frames_served = 0
        self._stats = {"step": 0, "steps_per_s": 0.0, "num_points": 0,
                       "loss": float("nan")}
        self._stats_lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _send(self, code: int, ctype: str, body: bytes) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif u.path == "/frame":
                    q = parse_qs(u.query)
                    eye = [float(v) for v in q["eye"][0].split(",")]
                    look = [float(v) for v in q["look"][0].split(",")]
                    t = float(q.get("t", ["0"])[0])
                    with outer.lock:
                        img = outer.render_fn(_look_at(eye, look), t)
                        if hasattr(img, "detach"):
                            img = img.detach().cpu().numpy()
                    body = visualization.png_bytes(np.asarray(img))
                    outer.frames_served += 1
                    self._send(200, "image/png", body)
                elif u.path == "/stats":
                    with outer._stats_lock:
                        body = json.dumps(
                            {**outer._stats, "paused": outer.paused})
                    self._send(200, "application/json", body.encode())
                else:
                    self._send(404, "application/json", b"{}")

            def do_POST(self):
                if urlparse(self.path).path == "/pause":
                    outer.paused = not outer.paused
                    self._send(200, "application/json", json.dumps(
                        {"paused": outer.paused}).encode())
                else:
                    self._send(404, "application/json", b"{}")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self.thread: Optional[threading.Thread] = None

    def start(self) -> "Viewer":
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()
        return self

    def stop(self) -> None:
        self.server.shutdown()
        self.server.server_close()

    def update_stats(self, **kw) -> None:
        with self._stats_lock:
            self._stats.update({k: (int(v) if k in ("step", "num_points")
                                    else float(v)) for k, v in kw.items()})

    def wait_if_paused(self, poll_s: float = 0.2) -> None:
        """Block the calling (training) thread while the page is paused."""
        while self.paused:
            time.sleep(poll_s)


def novel_view_renderer(get_state, statics, base_batch):
    """render_fn of a Viewer: the novel-view forward (no camera
    refinement, the test set's appearance) of the (trainer config, state)
    `get_state()` returns at the time of the frame, at base_batch's
    intrinsics and size, from a camera-to-world and a normalized time."""
    import torch

    from ..data.scene import _pixel_viewdirs
    from ..train import trainer

    K = base_batch["intrinsics"].detach().cpu().numpy()
    h, w = base_batch["pixels"].shape[:2]
    dev = base_batch["pixels"].device

    def render(c2w, t):
        tcfg, state = get_state()
        b = dict(base_batch)
        b["camera_to_world"] = torch.from_numpy(
            np.asarray(c2w, np.float32)).to(dev)
        b["viewdirs"] = torch.from_numpy(
            _pixel_viewdirs(h, w, K, c2w)).to(dev)
        b["normed_time"] = float(t)
        with torch.no_grad():
            out = trainer.forward(
                tcfg, state.params, trainer.merge_statics(statics, state.aux),
                state.masks, b, state.step, novel_view=True,
                in_test_set=True)
            return torch.clamp(out["rgb"], 0.0, 1.0)

    return render


def main(argv=None):
    import argparse
    import dataclasses
    import os

    from ..train import checkpoint
    from ..utils import config as config_lib
    from . import train as train_cli

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--log_dir", required=True)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--device", default="cuda")
    p.add_argument("opts", nargs="*")
    args = p.parse_args(argv)
    dev = train_cli.device_of(args.device)
    cfg = config_lib.load_config(os.path.join(args.log_dir, "config.json"),
                                 overrides=args.opts)
    tcfg, data, statics, state = train_cli.build(cfg, 0, dev)
    ckpt = args.checkpoint or checkpoint.latest_checkpoint(
        os.path.join(args.log_dir, "checkpoints"))
    if ckpt:
        state, extra = checkpoint.restore_checkpoint(ckpt, state)
        tcfg = dataclasses.replace(tcfg,
                                   isect_capacity=extra["isect_capacity"])
    v = Viewer(novel_view_renderer(lambda: (tcfg, state), statics,
                                   data.get_batch(0)),
               port=args.port).start()
    print(f"viewer at http://127.0.0.1:{v.port}/ (ctrl-c to stop)",
          flush=True)
    try:
        v.thread.join()
    except KeyboardInterrupt:
        v.stop()


if __name__ == "__main__":
    main()
