"""Live flight: browser sliders feed RPMs into a RUNNING sim.

Counterpart of scripts/live_fly.py (``PAGE`` :41, ``LiveSim`` :89,
``make_handler`` :179, ``serve`` :217). The reference's GUI debug sliders
set the motor RPMs of the running sim every step (BaseAviary.py:162-167
makes one slider a motor; ``_preprocessAction`` reads them,
BaseAviary.py:1053-1062, under ``user_debug_gui``). Without a GUI the
same contract is a stdlib HTTP server around ``CtrlAviary`` (the
direct-RPM playground, reference envs/CtrlAviary.py) on ``device`` (the
card unless the caller asks for the CPU): one HTML page with four RPM
sliders and a live chase-camera view ray-cast by ops/render.py on the
env's device, each frame sent as a PNG written without PIL
(utils/rendering.png_bytes). Moving a slider changes the running sim.
The companion replay is replay_viewer.py.

    python -m gym_pybullet_adrp_tpu_torch.live_fly [--port 8008] \\
        [--device cpu]

then open http://localhost:8008 (``--port 0`` lets the OS pick one; the
server prints it). The page polls ~20 times a second; each poll steps the
sim by the wall-clock time since the last poll (at most 0.25 s), so sim
time follows real time as the reference's ``sync()`` pacing does
(reference utils.py:47-66).
"""

import argparse
import base64
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from .utils.rendering import png_bytes

# the page, as the JAX package's :41-86, with MAXRPM and HOVERRPM filled
# in by the handler
PAGE = """<!DOCTYPE html>
<html><head><title>live fly</title><style>
body{font-family:monospace;background:#111;color:#eee;margin:2em}
input[type=range]{width:320px}
#view{image-rendering:pixelated;width:512px;height:384px;border:1px solid #444}
.row{margin:.4em 0} td{padding:0 .8em 0 0}
</style></head><body>
<h3>gym-pybullet-adrp-tpu &mdash; live RPM sliders (reference
BaseAviary user_debug_gui)</h3>
<div class=row><img id=view width=512 height=384></div>
<div id=sliders></div>
<div class=row>
<button onclick="hover()">all &rarr; hover RPM</button>
<button onclick="zero()">all &rarr; 0</button>
<button onclick="fetch('/reset',{method:'POST'})">reset</button>
</div>
<table id=stats></table>
<script>
const S=[];
function mk(i){
  const d=document.createElement('div'); d.className='row';
  d.innerHTML=`m${i} <input type=range id=s${i} min=0 max=MAXRPM step=1
    value=HOVERRPM oninput="push()"> <span id=v${i}></span>`;
  document.getElementById('sliders').appendChild(d); S.push(i);
}
for(let i=0;i<4;i++) mk(i);
function vals(){return S.map(i=>+document.getElementById('s'+i).value)}
function push(){
  S.forEach(i=>document.getElementById('v'+i).textContent=
    document.getElementById('s'+i).value);
  fetch('/rpm',{method:'POST',body:JSON.stringify(vals())});
}
function setall(v){S.forEach(i=>{document.getElementById('s'+i).value=v});push()}
function hover(){setall(HOVERRPM)} function zero(){setall(0)}
async function tick(){
  try{
    const r=await fetch('/state'); const st=await r.json();
    document.getElementById('view').src='data:image/png;base64,'+st.png;
    document.getElementById('stats').innerHTML=
      `<tr><td>t</td><td>${st.t.toFixed(2)} s</td></tr>`+
      `<tr><td>pos</td><td>${st.pos.map(x=>x.toFixed(2))}</td></tr>`+
      `<tr><td>rpy</td><td>${st.rpy.map(x=>x.toFixed(2))}</td></tr>`+
      `<tr><td>vel</td><td>${st.vel.map(x=>x.toFixed(2))}</td></tr>`+
      `<tr><td>rpm</td><td>${st.rpm.map(x=>x.toFixed(0))}</td></tr>`;
  }catch(e){}
  setTimeout(tick,50);
}
push(); tick();
</script></body></html>"""

# the live frame: rendered at 128 x 96 and sent at 4x, nearest neighbour
FRAME_W, FRAME_H, FRAME_SCALE = 128, 96, 4
# the chase camera's offset from the drone (m)
EYE_OFFSET = (-1.2, -1.2, 0.7)


class LiveSim:
    """CtrlAviary stepped by wall-clock elapsed time; the slider RPMs are
    applied at every control step (the reference's user_debug_gui
    contract). Running totals: ``n_steps`` control steps taken in
    ``step_seconds`` of host time; ``n_polls`` polls answered, whose
    frames (render, scale-up, PNG) took ``frame_seconds``."""

    def __init__(self, device="cuda"):
        from .envs.aviary import CtrlAviary

        self.env = CtrlAviary(num_drones=1, device=device)
        self.env.reset(seed=0)
        self.rpm = np.full((1, 4), self.env.HOVER_RPM, dtype=np.float32)
        self.t = 0.0
        self.last_poll = None
        self.n_steps, self.step_seconds = 0, 0.0
        self.n_polls, self.frame_seconds = 0, 0.0
        self.lock = threading.Lock()

    def frame(self, pos):
        """The chase camera's (H, W, 3) uint8 frame of a sphere at ``pos``
        over the checkerboard ground, on the env's device."""
        from .ops import render as rm

        dev, dt = self.env.device, self.env.dtype
        pos = torch.as_tensor(pos, dtype=dt, device=dev)

        def full(shape, v, dtype=dt):
            return torch.full(shape, v, dtype=dtype, device=dev)

        scene = rm.Scene(
            cap_center=full((1, 3), 0.0), cap_half=full((1,), 1.0),
            cap_radius=full((1,), 0.001), cap_color=full((1, 3), 0.5),
            cap_valid=full((1,), False, torch.bool),
            sph_center=pos[None], sph_radius=full((1,), 0.08),
            sph_color=torch.tensor([[0.9, 0.2, 0.1]], dtype=dt, device=dev),
            sph_valid=full((1,), True, torch.bool),
            seg_a=full((1, 3), 0.0), seg_b=full((1, 3), 1.0),
            seg_radius=full((1,), 0.001), seg_color=full((1, 3), 0.5),
            seg_valid=full((1,), False, torch.bool))
        eye = pos + torch.tensor(EYE_OFFSET, dtype=dt, device=dev)
        rgba, _, _ = rm.render(scene, eye, pos, width=FRAME_W,
                               height=FRAME_H)
        return rgba[..., :3].to(torch.uint8).cpu().numpy()

    def step_to_now(self):
        now = time.time()
        with self.lock:
            if self.last_poll is None:
                self.last_poll = now
            dt = min(now - self.last_poll, 0.25)     # cap the catch-up
            self.last_poll = now
            n = int(dt * self.env.CTRL_FREQ)
            t0 = time.perf_counter()
            for _ in range(n):
                self.env.step(self.rpm)
                self.t += 1.0 / self.env.CTRL_FREQ
            t1 = time.perf_counter()
            state = self.state()
            self.n_steps += n
            self.step_seconds += t1 - t0
            self.n_polls += 1
            self.frame_seconds += time.perf_counter() - t1
            return state

    def state(self):
        sv = self.env._stateVector()
        pos = sv[0, 0:3]
        img = self.frame(pos.astype(np.float32))
        big = np.repeat(np.repeat(img, FRAME_SCALE, axis=0), FRAME_SCALE,
                        axis=1)
        return {
            "t": self.t,
            "pos": pos.tolist(),
            "rpy": sv[0, 7:10].tolist(),
            "vel": sv[0, 10:13].tolist(),
            "rpm": self.rpm[0].tolist(),
            "png": base64.b64encode(png_bytes(big)).decode(),
        }

    def set_rpm(self, values):
        with self.lock:
            self.rpm = np.clip(
                np.asarray(values, dtype=np.float32).reshape(1, 4),
                0.0, self.env.MAX_RPM)

    def reset(self):
        with self.lock:
            self.env.reset(seed=0)
            self.t = 0.0


def make_handler(sim: LiveSim):
    class H(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, body, ctype="application/json"):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/":
                page = PAGE.replace(
                    "MAXRPM", str(int(sim.env.MAX_RPM))
                ).replace("HOVERRPM", str(int(sim.env.HOVER_RPM)))
                self._send(page.encode(), "text/html")
            elif self.path == "/state":
                self._send(json.dumps(sim.step_to_now()).encode())
            else:
                self.send_error(404)

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n)
            if self.path == "/rpm":
                sim.set_rpm(json.loads(body or b"[0,0,0,0]"))
                self._send(b"{}")
            elif self.path == "/reset":
                sim.reset()
                self._send(b"{}")
            else:
                self.send_error(404)

    return H


def serve(port=8008, device="cuda"):
    """The live server on 127.0.0.1:``port`` (0: a free port the OS
    picks; ``httpd.server_address[1]`` is the one bound), not yet
    serving: call its ``serve_forever``. Its ``sim`` is the ``LiveSim``."""
    sim = LiveSim(device=device)
    httpd = ThreadingHTTPServer(("127.0.0.1", port), make_handler(sim))
    httpd.sim = sim
    print(f"live fly: http://localhost:{httpd.server_address[1]}  "
          f"(ctrl-c to stop)", flush=True)
    return httpd


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    serve(args.port, args.device).serve_forever()


if __name__ == "__main__":
    main()
