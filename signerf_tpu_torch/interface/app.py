"""Built-in web viewer: a dependency-free HTTP UI over the Generation API.

Port of `signerf_tpu/interface/app.py`: the same page, routes, SSE stream
and render throttle, on the port's trainer. A threaded stdlib HTTP server:

  GET  /            the page: live NeRF view (orbit controls), training
                    stats, generation controls, preview, 3D overlays
                    (frustums, AABB, proxy) with drag and nudge
  GET  /state       training_state, step and GLOBAL_BUFFER's metrics (JSON)
  GET  /events      Server-Sent Events stream of the same JSON, pushed on
                    every step or state change (and a heartbeat)
  GET  /render      the current NeRF from an orbit camera (PNG); overlay
                    flags ?train=1&reference=1&synthetic=1&aabb=1&shape=1;
                    its `Server-Timing` header gives the wait for the train
                    lock, the render and the PNG encode (ms)
  GET  /scene       scene elements (poses, aabb, proxy stats; JSON)
  POST /preview     one reference-sheet generation, four base64 PNGs
  POST /generate    Generate Dataset & Train in a worker thread
  POST /train       {"state": "training"|"paused"}
  POST /params      generation params (prompt, steps, scales, seed)
  POST /nudge       {element, translate, scale, rotate_deg}
  POST /drag        {element, dx_px, dy_px, yaw, pitch, radius, size}
  POST /export      {"kind": "pointcloud"|"mesh", path?, downscale?,
                    resolution?, iso?, ...}: a PLY point cloud or an OBJ
                    mesh of the current model

Render-vs-train throttle: while training, a render's size comes from the
train rays/s EMA in GLOBAL_BUFFER (VIS_BUDGET_FRAC of it at VIS_TARGET_FPS),
128 px at most until the first EMA lands; each render publishes its own
rays/s as vis_rays_per_sec. A paused session renders at the size asked.

Renders and exports hold the trainer's `train_lock`, so they never overlap
an optimizer step or the dataset exchange, and run under
`torch.inference_mode()` (a handler thread starts with grad mode on). They
look the pipeline up at call time: `/generate` replaces it.

On a mesh of W > 1 ranks (one process a card, `parallel/mesh.py`) rank 0
alone serves HTTP and the other ranks follow (`run_interface`). The reads,
`/`, `/state`, `/events`, `/scene`, `/render` and `/export`, run on rank
0's replica as above and issue no collective: the render is the rank-local
one, and after each all-reduced step every rank holds the same parameters,
so rank 0's frame is the mesh's. The state changes (`/params`, `/nudge`,
`/drag`, `/train`) and the collective work (`/preview`, inpainted by rank
0's tensor group; `/generate`, whose generation, exchange and refinement
run on every rank) are commands of `interface/channel.py`: every rank runs
them in one order, from one thread, between train calls while training,
and the reply waits until every rank has run them.
"""

from __future__ import annotations

import base64
import functools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from signerf_tpu_torch.engine.writer import GLOBAL_BUFFER
from signerf_tpu_torch.interface.api import GenerationInterface
from signerf_tpu_torch.interface.channel import CommandChannel
from signerf_tpu_torch.utils.images import encode_png

_PAGE = """<!DOCTYPE html>
<html><head><title>SIGNeRF-TPU</title><style>
body{font-family:sans-serif;margin:1rem;background:#111;color:#eee}
.row{display:flex;gap:1rem;flex-wrap:wrap}
.card{background:#1c1c1c;padding:1rem;border-radius:8px}
img{image-rendering:pixelated;border:1px solid #333}
button{margin:0.2rem;padding:0.4rem 0.8rem}
input,select{margin:0.2rem;background:#222;color:#eee;border:1px solid #444}
</style></head><body>
<h2>SIGNeRF-TPU viewer</h2>
<div class="row">
 <div class="card"><h3>Scene</h3>
  <img id="view" width="384" height="384" draggable="false"/><br/>
  yaw <input id="yaw" type="range" min="0" max="360" value="30"/>
  pitch <input id="pitch" type="range" min="5" max="85" value="55"/>
  radius <input id="radius" type="number" value="2.0" step="0.2" style="width:4em"/><br/>
  show: <label><input id="ov_train" type="checkbox" checked/>train cams</label>
  <label><input id="ov_reference" type="checkbox" checked/>reference</label>
  <label><input id="ov_synthetic" type="checkbox"/>synthetic</label>
  <label><input id="ov_aabb" type="checkbox" checked/>AABB</label>
  <label><input id="ov_shape" type="checkbox"/>proxy</label><br/>
  drag target:
  <select id="dragel"><option>none</option><option>aabb</option>
   <option>shape</option><option>reference</option></select>
  <span style="color:#888">(drag on the view moves it in the camera plane)</span>
 </div>
 <div class="card"><h3>Selection</h3>
  element <select id="nel"><option>aabb</option><option>shape</option>
   <option>reference</option></select>
  step <input id="nstep" type="number" value="0.05" step="0.01" style="width:4em"/><br/>
  <button onclick="nt(1,0,0)">+x</button><button onclick="nt(-1,0,0)">-x</button>
  <button onclick="nt(0,1,0)">+y</button><button onclick="nt(0,-1,0)">-y</button>
  <button onclick="nt(0,0,1)">+z</button><button onclick="nt(0,0,-1)">-z</button><br/>
  <button onclick="ns(1.1)">grow</button><button onclick="ns(0.9)">shrink</button>
  <button onclick="nr(15)">rot+15&deg;</button><button onclick="nr(-15)">rot-15&deg;</button>
 </div>
 <div class="card"><h3>Training</h3>
  <pre id="state">...</pre>
  <button onclick="post('/train',{state:'training'})">Resume</button>
  <button onclick="post('/train',{state:'paused'})">Pause</button>
 </div>
 <div class="card"><h3>Generation</h3>
  prompt <input id="prompt" size="40" value=""/><br/>
  steps <input id="steps" type="number" value="20" style="width:4em"/>
  seed <input id="seed" type="number" value="1" style="width:4em"/>
  cfg <input id="cfg" type="number" value="7.0" step="0.5" style="width:4em"/>
  cn <input id="cn" type="number" value="0.8" step="0.1" style="width:4em"/><br/>
  <button onclick="setParams()">Apply params</button>
  <button onclick="preview()">Preview Generation</button>
  <button onclick="post('/generate',{})">Generate Dataset &amp; Train</button>
  <div id="preview" class="row"></div>
 </div>
 <div class="card"><h3>Export</h3>
  <button onclick="doExport('pointcloud')">Point cloud (.ply)</button>
  <button onclick="doExport('mesh')">Mesh (.obj)</button>
  <pre id="exp"></pre>
 </div>
</div>
<script>
async function post(u, body){await fetch(u,{method:'POST',body:JSON.stringify(body)});}
async function doExport(kind){
  document.getElementById('exp').textContent='exporting…';
  const r = await fetch('/export',{method:'POST',body:JSON.stringify({kind})});
  document.getElementById('exp').textContent=JSON.stringify(await r.json());}
function setParams(){post('/params',{prompt:prompt.value,num_inference_steps:+steps.value,
  seed:+seed.value,guidance_scale:+cfg.value,controlnet_conditioning_scale:+cn.value});}
async function preview(){
  document.getElementById('preview').innerHTML='generating…';
  const r = await fetch('/preview',{method:'POST'}); const d = await r.json();
  document.getElementById('preview').innerHTML = Object.entries(d).map(
    ([k,v])=>`<div>${k}<br/><img width="256" src="data:image/png;base64,${v}"/></div>`).join('');
}
function nt(x,y,z){const s=+nstep.value;
  post('/nudge',{element:nel.value,translate:[x*s,y*s,z*s]});refresh();}
function ns(f){post('/nudge',{element:nel.value,scale:f});refresh();}
function nr(d){post('/nudge',{element:nel.value,rotate_deg:[0,0,d]});refresh();}
function ovq(){return ['train','reference','synthetic','aabb','shape'].map(
  k=>k+'='+(document.getElementById('ov_'+k).checked?1:0)).join('&');}
function refresh(){
  document.getElementById('view').src = '/render?yaw='+yaw.value+'&pitch='+pitch.value+
    '&radius='+radius.value+'&size=192&'+ovq()+'&t='+Date.now();}
let drag=null;
view.addEventListener('mousedown',e=>{if(dragel.value!=='none')
  drag={x:e.offsetX,y:e.offsetY};});
view.addEventListener('mouseup',async e=>{
  if(!drag||dragel.value==='none'){drag=null;return;}
  const scale=192/view.width;  // displayed px -> render px
  await post('/drag',{element:dragel.value,
    dx_px:(e.offsetX-drag.x)*scale, dy_px:(e.offsetY-drag.y)*scale,
    yaw:+yaw.value, pitch:+pitch.value, radius:+radius.value, size:192});
  drag=null; refresh();});
// Push updates: the server streams state over SSE on every step/state
// change; the view re-renders on push, paced so a new render is only
// requested once the previous one has loaded (the server already sizes
// renders from its measured rays/s budget).
let rendering=false, pending=false;
const viewEl=document.getElementById('view');
viewEl.addEventListener('load',()=>{rendering=false;
  if(pending){pending=false;refresh();}});
viewEl.addEventListener('error',()=>{rendering=false;});
const _refresh=refresh;
refresh=function(){
  if(rendering){pending=true;return;}
  rendering=true; _refresh();
};
const es = new EventSource('/events');
es.onmessage = (e)=>{
  const s = JSON.parse(e.data);
  document.getElementById('state').textContent = JSON.stringify(s,null,1);
  refresh();
};
es.onerror = ()=>{ /* EventSource auto-reconnects */ };
refresh();
</script></body></html>"""

# The viewer's commands: the interface's method each runs ("train" sets the
# trainer's state). On a mesh every rank runs them through the channel.
COMMANDS = {"params": "set_generation_params", "nudge": "nudge", "drag": "drag", "preview": "preview_generation",
            "generate": "generate_and_train"}


def run_command(interface: GenerationInterface, name: str, args: tuple, kwargs: dict):
    """Viewer command `name` on this rank; its result."""
    if name == "train":
        (interface.trainer.training_state,) = args
        return args[0]
    return getattr(interface, COMMANDS[name])(*args, **kwargs)


class ViewerServer:
    # viewer render budget: the fraction of the measured train throughput
    # one on-push render may take, at the target update rate
    VIS_BUDGET_FRAC = 0.15
    VIS_TARGET_FPS = 2.0
    # SSE cadence: the state is checked at this period; the heartbeat
    # pushes even without a change, so proxies keep the stream open
    SSE_POLL_S = 0.25
    SSE_HEARTBEAT_S = 5.0

    def __init__(self, interface: GenerationInterface, port: int = 7007, channel: Optional[CommandChannel] = None):
        """`channel`: on a mesh, rank 0's end of the command channel (None:
        one process, commands run in the handler's thread)."""
        self.interface = interface
        self.port = port
        self.channel = channel
        self._worker: Optional[threading.Thread] = None  # one process: the /generate thread
        self._generation = None  # on a mesh: the /generate command's future
        self._start_lock = threading.Lock()

    def command(self, name: str, *args, **kwargs):
        """Run a viewer command here, or on every rank through the channel."""
        if self.channel is not None:
            return self.channel.call(name, *args, **kwargs)
        return run_command(self.interface, name, args, kwargs)

    def generation_running(self) -> bool:
        if self.channel is not None:
            return self._generation is not None and not self._generation.done()
        return self._worker is not None and self._worker.is_alive()

    def start_generation(self) -> bool:
        """Start Generate Dataset & Train unless it is running; whether it started."""
        with self._start_lock:
            if self.generation_running():
                return False
            if self.channel is not None:
                self._generation = self.channel.submit("generate")
            else:
                self._worker = threading.Thread(target=self.interface.generate_and_train, daemon=True)
                self._worker.start()
            return True

    def _state_dict(self):
        t = self.interface.trainer
        return {
            "training_state": t.training_state,
            "step": t.step,
            "metrics": {k: round(v, 4) for k, v in GLOBAL_BUFFER.items()},
        }

    # ------------------------------------------------------------------

    def _orbit_cam(self, yaw: float, pitch: float, radius: float, size: int):
        from signerf_tpu_torch.cameras.poses import circle_poses

        pose = circle_poses(1, radius=radius, theta=pitch, phi=(yaw, yaw)).numpy()[0, :3, :]
        return {"c2w": pose, "fx": size * 1.2, "fy": size * 1.2, "cx": size / 2, "cy": size / 2}

    def render_size(self, size: int) -> int:
        """The throttled size of a render asked at `size` px."""
        if self.interface.trainer.training_state != "training":
            return size
        return self.throttled_size(size, GLOBAL_BUFFER.get("train_rays_per_sec", 0.0))

    def throttled_size(self, size: int, tput: float) -> int:
        """The size of a render asked at `size` px while training runs at
        `tput` train rays/s (0: not measured yet)."""
        if tput > 0:
            allowed = tput * self.VIS_BUDGET_FRAC / self.VIS_TARGET_FPS
            return int(min(size, max(64, np.sqrt(allowed))))
        return min(size, 128)

    def _render_view(
        self,
        yaw: float,
        pitch: float,
        radius: float,
        size: int = 128,
        show: Optional[dict] = None,
        timings: Optional[dict] = None,
    ) -> np.ndarray:
        """The orbit view [size', size', 3] in [0, 1] at the throttled size,
        with the overlays in `show` drawn over it. `timings` gets the wait
        for the train lock and the render, in seconds."""
        from signerf_tpu_torch.cameras.cameras import Cameras
        from signerf_tpu_torch.interface.overlay import compose_overlays

        trainer = self.interface.trainer
        size = self.render_size(size)
        cam = self._orbit_cam(yaw, pitch, radius, size)
        t_wait = time.perf_counter()
        with trainer.train_lock, torch.inference_mode():
            t_render = time.perf_counter()
            pipeline = trainer.pipeline
            dev = pipeline.device
            cams = Cameras(
                camera_to_worlds=torch.as_tensor(cam["c2w"], dtype=torch.float32, device=dev)[None],
                fx=torch.full((1,), cam["fx"], device=dev),
                fy=torch.full((1,), cam["fy"], device=dev),
                cx=torch.full((1,), cam["cx"], device=dev),
                cy=torch.full((1,), cam["cy"], device=dev),
                width=size,
                height=size,
            )
            rb = cams.generate_rays(camera_index=0)
            out = pipeline._render(rb.reshape((size * size,)))
            rgb = out["rgb"].reshape(size, size, 3).float().cpu().numpy()
            t_done = time.perf_counter()
        # publish the viewer's measured throughput
        cur = size * size / max(t_done - t_render, 1e-6)
        ema = GLOBAL_BUFFER.get("vis_rays_per_sec")
        GLOBAL_BUFFER["vis_rays_per_sec"] = cur if ema is None else 0.8 * ema + 0.2 * cur
        if timings is not None:
            timings.update(lock_s=t_render - t_wait, render_s=t_done - t_render)
        if show and any(show.values()):
            rgb = compose_overlays(rgb, cam, self.interface.scene_elements(), show)
        return rgb

    def export_asset(self, kind: str, path, **kw):
        """A point cloud or mesh of the current model through the export
        CLI's core. The defaults are sized for a viewer; the export CLI is
        the heavy path."""
        from signerf_tpu_torch.export import density_fn, mesh_from_density, pointcloud_from_renders, write_ply

        trainer = self.interface.trainer
        with trainer.train_lock, torch.inference_mode():
            pipeline = trainer.pipeline
            if kind == "mesh":
                from signerf_tpu_torch.geometry.marching import save_obj

                box = np.asarray(pipeline.datamanager.outputs.scene_box_aabb, np.float32)
                verts, faces = mesh_from_density(
                    density_fn(pipeline.model, pipeline.device), box[0], box[1], int(kw.get("resolution", 96)),
                    kw.get("iso", 15.0),
                )
                save_obj(path, verts, faces)
                return {"vertices": int(len(verts)), "faces": int(len(faces)), "path": str(path)}
            cams = pipeline.datamanager.cameras
            ds = int(kw.get("downscale", 4))
            if ds > 1:
                cams = cams.rescaled(1.0 / ds)
            aabb = torch.as_tensor(pipeline.datamanager.outputs.scene_box_aabb, device=pipeline.device)
            pts, cols = pointcloud_from_renders(
                lambda flat: pipeline._render(flat, appearance_mode="index"),
                cams,
                aabb,
                min_accumulation=float(kw.get("min_accumulation", 0.5)),
                num_points=int(kw.get("num_points", 1_000_000)),
                log=lambda *_: None,
            )
        write_ply(path, pts, cols)
        return {"points": int(len(pts)), "path": str(path)}

    # ------------------------------------------------------------------

    def make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def _send(self, data: bytes, content_type: str, code: int = 200, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(data)))
                for key, val in headers:
                    self.send_header(key, val)
                self.end_headers()
                self.wfile.write(data)

            def _json(self, obj, code=200):
                self._send(json.dumps(obj).encode(), "application/json", code)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(_PAGE.encode(), "text/html")
                elif url.path == "/state":
                    self._json(server._state_dict())
                elif url.path == "/events":
                    # SSE: push the state whenever step or training_state
                    # move (and a heartbeat); one thread per client.
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()
                    last_sig, last_push = None, 0.0
                    try:
                        while True:
                            s = server._state_dict()
                            sig = (s["training_state"], s["step"])
                            now = time.time()
                            if sig != last_sig or now - last_push > server.SSE_HEARTBEAT_S:
                                self.wfile.write(f"data: {json.dumps(s)}\n\n".encode())
                                self.wfile.flush()
                                last_sig, last_push = sig, now
                            time.sleep(server.SSE_POLL_S)
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # the client went away
                elif url.path == "/render":
                    q = parse_qs(url.query)
                    try:
                        show = {
                            k: q.get(k, ["0"])[0] in ("1", "true")
                            for k in ("train", "reference", "synthetic", "aabb", "shape")
                        }
                        timings = {}
                        img = server._render_view(
                            float(q.get("yaw", ["30"])[0]),
                            float(q.get("pitch", ["55"])[0]),
                            float(q.get("radius", ["2.0"])[0]),
                            int(q.get("size", ["128"])[0]),
                            show=show,
                            timings=timings,
                        )
                        t0 = time.perf_counter()
                        data = encode_png(img)
                        timings["png_s"] = time.perf_counter() - t0
                        spans = ", ".join(
                            f"{k[:-2]};dur={v * 1e3:.3f}" for k, v in timings.items()
                        )
                        self._send(data, "image/png", headers=[("Server-Timing", spans)])
                    except Exception as exc:  # a render can race a dataset swap
                        self._json({"error": str(exc)}, 500)
                elif url.path == "/scene":
                    s = server.interface.scene_elements()

                    def poses_list(p):
                        return None if p is None else np.asarray(p).tolist()

                    self._json(
                        {
                            "train_poses": poses_list(s["train_poses"]),
                            "reference_poses": poses_list(s["reference_poses"]),
                            "synthetic_poses": poses_list(s["synthetic_poses"]),
                            "aabb": None if s["aabb"] is None else [list(s["aabb"][0]), list(s["aabb"][1])],
                            "shape": None
                            if s["shape"] is None
                            else {
                                "num_verts": int(len(s["shape"]["verts"])),
                                "num_faces": int(len(s["shape"]["faces"])),
                                "center": np.asarray(s["shape"]["verts"]).mean(0).tolist(),
                            },
                            "masking_mode": server.interface.gen_config.masking_mode,
                        }
                    )
                else:
                    self._json({"error": "not found"}, 404)

            def _reply(self, fn):
                """`fn()`'s result as JSON; a bad request 400, another error 500."""
                try:
                    result = fn()
                except (KeyError, ValueError, TypeError) as exc:
                    self._json({"error": str(exc)}, 400)
                except Exception as exc:  # noqa: BLE001 - e.g. a command that failed on another rank
                    self._json({"error": f"{type(exc).__name__}: {exc}"}, 500)
                else:
                    self._json(result)

            def do_POST(self):
                url = urlparse(self.path)
                length = int(self.headers.get("Content-Length", 0) or 0)
                body = {}
                if length:
                    try:
                        body = json.loads(self.rfile.read(length) or b"{}")
                    except json.JSONDecodeError:
                        body = {}
                if url.path == "/preview":

                    def preview():
                        sheets = server.command("preview")
                        return {k: base64.b64encode(encode_png(v)).decode() for k, v in sheets.items()}

                    self._reply(preview)
                elif url.path == "/generate":
                    if server.start_generation():
                        self._json({"started": True})
                    else:
                        self._json({"started": False, "reason": "busy"})
                elif url.path == "/train":
                    state = body.get("state", "training")
                    self._reply(lambda: {"training_state": server.command("train", state)})
                elif url.path == "/params":
                    self._reply(lambda: server.command("params", **body) or {"ok": True})
                elif url.path == "/nudge":
                    self._reply(lambda: server.command(
                        "nudge",
                        body["element"],
                        translate=tuple(body.get("translate", (0, 0, 0))),
                        scale=float(body.get("scale", 1.0)),
                        rotate_deg=tuple(body.get("rotate_deg", (0, 0, 0))),
                    ) or {"ok": True})
                elif url.path == "/export":
                    try:
                        kind = body.pop("kind", "pointcloud")
                        if kind not in ("pointcloud", "mesh"):
                            raise ValueError(f"unknown export kind {kind!r}")
                        out_dir = Path(getattr(server.interface.trainer.config, "output_dir", "outputs")) / "exports"
                        out_dir.mkdir(parents=True, exist_ok=True)
                        default = "point_cloud.ply" if kind == "pointcloud" else "mesh.obj"
                        path = Path(body.pop("path", out_dir / default))
                        self._json(server.export_asset(kind, path, **body))
                    except (KeyError, ValueError) as exc:
                        self._json({"error": str(exc)}, 400)
                elif url.path == "/drag":

                    def drag():
                        size = int(body.get("size", 128))
                        cam = server._orbit_cam(
                            float(body.get("yaw", 30.0)),
                            float(body.get("pitch", 55.0)),
                            float(body.get("radius", 2.0)),
                            size,
                        )
                        return server.command("drag", body["element"], float(body["dx_px"]), float(body["dy_px"]),
                                              cam) or {"ok": True}

                    self._reply(drag)
                else:
                    self._json({"error": "not found"}, 404)

        return Handler

    def serve_forever(self):
        httpd = ThreadingHTTPServer(("0.0.0.0", self.port), self.make_handler())
        print(f"[viewer] http://0.0.0.0:{self.port}", flush=True)
        httpd.serve_forever()

    def start_background(self):
        """Serve from a daemon thread; returns the server (`shutdown()` it)."""
        httpd = ThreadingHTTPServer(("0.0.0.0", self.port), self.make_handler())
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        print(f"[viewer] http://0.0.0.0:{httpd.server_address[1]}", flush=True)
        return httpd


def run_interface(trainer, port: int = 7007):
    """Interactive mode: serve the viewer, training paused until the user
    clicks "Generate Dataset & Train". On a mesh of more than one rank,
    rank 0 serves on `port` and every rank, rank 0 too, runs the viewer's
    commands on its main thread until the channel closes."""
    interface = GenerationInterface(trainer)
    trainer.training_state = "paused"
    mesh = getattr(trainer, "mesh", None)
    if mesh is None or mesh.world_size == 1:
        ViewerServer(interface, port=port).serve_forever()
        return
    channel = CommandChannel(mesh, functools.partial(run_command, interface), ends_word=("generate",))
    trainer.control = functools.partial(channel.follow, trainer)
    httpd = None
    if mesh.is_main:
        httpd = ViewerServer(interface, port=port, channel=channel).start_background()
        print(f"[viewer] rank 0 of {mesh.world_size} serves; the other ranks follow its commands", flush=True)
    try:
        channel.serve()
    finally:
        trainer.control = None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
