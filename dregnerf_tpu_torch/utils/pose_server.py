"""Live pose-visualization server (port of dregnerf_tpu/utils/pose_server.py,
stdlib and numpy only).

A ThreadingHTTPServer serving

  /            an inline HTML+canvas orbit viewer (drag = rotate,
               wheel = zoom, polls state every 2 s; no external JS)
  /state.json  the latest traces pushed by the trainer

Trainers push with `visualize_cameras` (pose sets -> coloured frustum
wireframes, and with two sets the centre-to-centre segments) and
`point_trace` (voxel clouds under the ground-truth and the predicted
transforms). Everything is numpy in, JSON out.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Sequence

import numpy as np

# frustum model: 4 image-plane corners at depth 1 + the optical center
# (reference pose_visualizer.get_camera_mesh:11-30)
_CAM_VERTS = np.array(
    [[-0.5, -0.5, 1.0], [0.5, -0.5, 1.0], [0.5, 0.5, 1.0], [-0.5, 0.5, 1.0],
     [0.0, 0.0, 0.0]],
    np.float32,
)
# wireframe visit order over those 5 vertices (reference :28)
_WIRE_ORDER = [0, 1, 2, 3, 0, 4, 1, 2, 4, 3]


def _as_mat4(pose: np.ndarray) -> np.ndarray:
    pose = np.asarray(pose, np.float32)
    if pose.ndim == 2:
        pose = pose[None]
    if pose.shape[-2:] == (3, 4):
        bottom = np.tile(
            np.array([[[0, 0, 0, 1]]], np.float32), (pose.shape[0], 1, 1))
        pose = np.concatenate([pose, bottom], axis=-2)
    return pose  # [N, 4, 4]


def camera_wireframes(pose: np.ndarray, depth: float = 0.5) -> np.ndarray:
    """[N, 10, 3] world-space frustum wireframes (one per camera)."""
    pose = _as_mat4(pose)
    verts = _CAM_VERTS * depth  # [5, 3]
    world = np.einsum("nij,kj->nki", pose[:, :3, :3], verts)
    world = world + pose[:, None, :3, 3]
    return world[:, _WIRE_ORDER]  # [N, 10, 3]


def _lines_json(segments: np.ndarray) -> list:
    """[M, K, 3] polylines -> flat coordinate list with None separators
    (the plotly/visdom wire-merge convention, reference :33-40)."""
    out = []
    for poly in segments:
        out.extend([[round(float(x), 4) for x in p] for p in poly])
        out.append(None)
    return out


class PoseVizServer:
    """Threaded HTTP server holding the latest visualization state."""

    def __init__(self, port: int = 8097, host: str = "127.0.0.1"):
        self._state = {"step": None, "traces": []}
        self._lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def do_GET(self):
                if self.path.startswith("/state.json"):
                    with outer._lock:
                        body = json.dumps(outer._state).encode()
                    ctype = "application/json"
                else:
                    body = _VIEWER_HTML.encode()
                    ctype = "text/html"
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer((host, port), Handler)
        self.port = self.httpd.server_address[1]  # resolved (port=0 ok)
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True)
        self._thread.start()

    def push(self, step: int, traces: list) -> None:
        with self._lock:
            self._state = {"step": int(step), "traces": traces}

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()


def visualize_cameras(
    vis: PoseVizServer,
    step: int,
    poses: Sequence[np.ndarray],
    cam_depth: float = 0.5,
    colors: Sequence[str] = ("blue", "magenta"),
    plot_dist: bool = True,
    extra_traces: list | None = None,
) -> None:
    """Push frusta for each pose set; with two sets and plot_dist, also the
    per-camera center-connection segments (reference
    pose_visualizer.visualize_cameras:63-152 semantics)."""
    traces = list(extra_traces or [])
    centers = []
    for pose, color in zip(poses, colors):
        wires = camera_wireframes(np.asarray(pose), depth=cam_depth)
        centers.append(_as_mat4(np.asarray(pose))[:, :3, 3])
        traces.append({
            "kind": "lines", "color": color,
            "points": _lines_json(wires),
        })
    if plot_dist and len(centers) >= 2:
        n = min(len(centers[0]), len(centers[1]))
        seg = np.stack([centers[0][:n], centers[1][:n]], axis=1)  # [n, 2, 3]
        traces.append({
            "kind": "lines", "color": "red", "dash": True,
            "points": _lines_json(seg),
        })
    vis.push(step, traces)


def point_trace(points: np.ndarray, color: str, max_points: int = 800,
                seed: int = 0) -> dict:
    """A scatter trace from an [N, 3] cloud, subsampled for the wire."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if len(pts) > max_points:
        idx = np.random.default_rng(seed).choice(
            len(pts), max_points, replace=False)
        pts = pts[idx]
    return {
        "kind": "points", "color": color,
        "points": [[round(float(x), 4) for x in p] for p in pts],
    }


_VIEWER_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>dregnerf-tpu poses</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace}
 #hud{position:fixed;top:8px;left:10px}
 canvas{display:block}
</style></head><body>
<div id="hud">dregnerf-tpu pose viewer — drag: rotate, wheel: zoom</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),cx=cv.getContext('2d');
let st={step:null,traces:[]},yaw=0.7,pitch=0.5,zoom=180,drag=null;
function resize(){cv.width=innerWidth;cv.height=innerHeight;}
addEventListener('resize',resize);resize();
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 yaw+=(e.clientX-drag[0])*0.01;pitch+=(e.clientY-drag[1])*0.01;
 pitch=Math.max(-1.55,Math.min(1.55,pitch));drag=[e.clientX,e.clientY];draw();});
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);draw();e.preventDefault();};
function proj(p){
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const x=cy*p[0]+sy*p[2],z=-sy*p[0]+cy*p[2];
 const y=cp*p[1]-sp*z,zz=sp*p[1]+cp*z;
 const s=zoom*3/(3+zz);
 return [cv.width/2+x*s,cv.height/2-y*s];
}
function draw(){
 cx.fillStyle='#111';cx.fillRect(0,0,cv.width,cv.height);
 for(const t of st.traces){
  cx.strokeStyle=cx.fillStyle=t.color||'#8cf';
  cx.setLineDash(t.dash?[4,4]:[]);
  if(t.kind==='points'){
   for(const p of t.points){if(!p)continue;const q=proj(p);
    cx.fillRect(q[0]-1.5,q[1]-1.5,3,3);}
  }else{
   cx.beginPath();let pen=false;
   for(const p of t.points){
    if(!p){pen=false;continue;}
    const q=proj(p);
    if(pen)cx.lineTo(q[0],q[1]);else cx.moveTo(q[0],q[1]);
    pen=true;}
   cx.stroke();}
 }
 cx.setLineDash([]);cx.fillStyle='#ddd';
 cx.fillText('step '+st.step,10,innerHeight-12);
}
async function poll(){
 try{st=await (await fetch('state.json')).json();draw();}catch(e){}
 setTimeout(poll,2000);
}
poll();
</script></body></html>
"""
