"""Self-contained interactive HTML point-cloud / grasp viewer (a numpy copy
of s4g_tpu/utils/html_viewer.py; for the same inputs it writes the same
HTML, byte for byte).

Replaces the reference's Open3D ``VisualizerWithEditing`` pick-a-point
workflow (reference: data_gen/visualize_single_grasp.py:36-56,
README.md:81-96) with a zero-dependency HTML file: a vanilla-JS canvas
renderer with drag-rotate / wheel-zoom, shift-click point picking, and
gripper wireframes drawn for every labeled grasp frame at the picked point.
Works over ssh (scp the file, open in any browser) — no GUI stack, no CDN.
"""

from __future__ import annotations

import json

import numpy as np

from ..configs import gripper_config as G
from ..configs import processing_config as P


def _gripper_wireframe_segments() -> np.ndarray:
    """Line segments (S, 2, 3) of the 3-box gripper in the grasp-local frame
    (same geometry as utils/grasp_visualizer.py::gripper_hand_mesh)."""
    boxes = [
        # back hand
        ((-G.BOTTOM_LENGTH, -G.HALF_BOTTOM_WIDTH, -G.HALF_HAND_THICKNESS),
         (-P.BACK_COLLISION_MARGIN, G.HALF_BOTTOM_WIDTH,
          G.HALF_HAND_THICKNESS)),
        # left finger
        ((-P.BACK_COLLISION_MARGIN, G.HALF_BOTTOM_SPACE,
          -G.HALF_HAND_THICKNESS),
         (G.FINGER_LENGTH, G.HALF_BOTTOM_WIDTH, G.HALF_HAND_THICKNESS)),
        # right finger
        ((-P.BACK_COLLISION_MARGIN, -G.HALF_BOTTOM_WIDTH,
          -G.HALF_HAND_THICKNESS),
         (G.FINGER_LENGTH, -G.HALF_BOTTOM_SPACE, G.HALF_HAND_THICKNESS)),
    ]
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    segs = []
    for lo, hi in boxes:
        corners = np.array([[(hi if (i >> a) & 1 else lo)[a]
                             for a in range(3)] for i in range(8)])
        for a, b in edges:
            segs.append([corners[a], corners[b]])
    return np.asarray(segs, dtype=np.float64)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>s4g_tpu grasp viewer</title>
<style>
 body {{ margin:0; display:flex; font-family:monospace; background:#111;
        color:#ddd; }}
 #c {{ cursor:grab; }}
 #side {{ width:320px; padding:10px; overflow-y:auto; height:100vh;
          box-sizing:border-box; }}
 pre {{ font-size:11px; }}
</style></head><body>
<canvas id="c"></canvas>
<div id="side">
 <h3>s4g_tpu grasp viewer</h3>
 <p>drag: rotate &middot; wheel: zoom &middot; shift-click: pick a labeled
 point (highlighted) to show its grasp frames</p>
 <div id="info">no point picked</div>
 <pre id="mat"></pre>
</div>
<script>
const DATA = {data_json};
const canvas = document.getElementById('c');
const ctx = canvas.getContext('2d');
let W, H;
function fit() {{
  W = window.innerWidth - 320; H = window.innerHeight;
  canvas.width = W; canvas.height = H;
}}
fit(); window.onresize = () => {{ fit(); draw(); }};

const pts = DATA.points;          // [n][3]
const col = DATA.colors;          // [n] css color strings
const labeled = DATA.labeled;     // indices into pts with frames
const frames = DATA.frames;       // [labeled.length][k][16] row-major 4x4
const seg = DATA.gripper;         // [s][2][3] local-frame segments
// center + scale
let cx=0, cy=0, cz=0;
for (const p of pts) {{ cx+=p[0]; cy+=p[1]; cz+=p[2]; }}
cx/=pts.length; cy/=pts.length; cz/=pts.length;
let ext = 0;
for (const p of pts) ext = Math.max(ext, Math.abs(p[0]-cx),
                                    Math.abs(p[1]-cy), Math.abs(p[2]-cz));
let yaw = 0.6, pitch = -0.9, zoom = 0.42 * Math.min(W, H) / ext;
let picked = -1;
const proj = new Float64Array(pts.length * 2);

function rot() {{
  const cy_ = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  // R = Rx(pitch) * Rz(yaw)
  return [cy_, -sy, 0,
          cp*sy, cp*cy_, -sp,
          sp*sy, sp*cy_, cp];
}}
function project(x, y, z, R) {{
  const dx = x-cx, dy = y-cy, dz = z-cz;
  const px = R[0]*dx + R[1]*dy + R[2]*dz;
  const py = R[3]*dx + R[4]*dy + R[5]*dz;
  return [W/2 + px*zoom, H/2 - py*zoom];
}}
function draw() {{
  const R = rot();
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  for (let i = 0; i < pts.length; i++) {{
    const s = project(pts[i][0], pts[i][1], pts[i][2], R);
    proj[2*i] = s[0]; proj[2*i+1] = s[1];
    ctx.fillStyle = col[i];
    ctx.fillRect(s[0], s[1], 2, 2);
  }}
  // labeled points ring
  ctx.strokeStyle = '#fff';
  for (const i of labeled) {{
    ctx.beginPath();
    ctx.arc(proj[2*i], proj[2*i+1], 2.5, 0, 6.283);
    ctx.stroke();
  }}
  if (picked >= 0) {{
    const li = labeled.indexOf(picked);
    ctx.fillStyle = '#ff0';
    ctx.beginPath();
    ctx.arc(proj[2*picked], proj[2*picked+1], 5, 0, 6.283);
    ctx.fill();
    ctx.lineWidth = 1.5;
    for (let k = 0; k < frames[li].length; k++) {{
      const M = frames[li][k];   // local->global, row-major
      ctx.strokeStyle = `hsl(${{(k*67)%360}},90%,60%)`;
      for (const sgm of seg) {{
        ctx.beginPath();
        let first = true;
        for (const q of sgm) {{
          const gx = M[0]*q[0]+M[1]*q[1]+M[2]*q[2]+M[3];
          const gy = M[4]*q[0]+M[5]*q[1]+M[6]*q[2]+M[7];
          const gz = M[8]*q[0]+M[9]*q[1]+M[10]*q[2]+M[11];
          const s = project(gx, gy, gz, R);
          if (first) {{ ctx.moveTo(s[0], s[1]); first = false; }}
          else ctx.lineTo(s[0], s[1]);
        }}
        ctx.stroke();
      }}
    }}
    ctx.lineWidth = 1;
  }}
}}
let dragging = false, lx = 0, ly = 0, moved = 0;
canvas.onmousedown = e => {{ dragging = true; lx = e.clientX;
                             ly = e.clientY; moved = 0; }};
window.onmouseup = () => dragging = false;
window.onmousemove = e => {{
  if (!dragging) return;
  moved += Math.abs(e.clientX-lx) + Math.abs(e.clientY-ly);
  yaw += (e.clientX-lx) * 0.008; pitch += (e.clientY-ly) * 0.008;
  lx = e.clientX; ly = e.clientY; draw();
}};
canvas.onwheel = e => {{ e.preventDefault();
  zoom *= Math.exp(-e.deltaY * 0.001); draw(); }};
canvas.onclick = e => {{
  if (!e.shiftKey || moved > 4) return;
  const mx = e.clientX, my = e.clientY;
  let best = -1, bd = 144;  // 12 px pick radius
  for (const i of labeled) {{
    const d = (proj[2*i]-mx)**2 + (proj[2*i+1]-my)**2;
    if (d < bd) {{ bd = d; best = i; }}
  }}
  picked = best;
  const info = document.getElementById('info');
  const mat = document.getElementById('mat');
  if (best < 0) {{ info.textContent = 'no point picked';
                   mat.textContent = ''; }}
  else {{
    const li = labeled.indexOf(best);
    info.textContent = `point ${{best}}: ${{frames[li].length}} frame(s)` +
      ` at [${{pts[best].map(v => v.toFixed(4)).join(', ')}}]`;
    mat.textContent = frames[li].map((M, k) =>
      `frame ${{k}} (local->global)\\n` + [0,1,2,3].map(r =>
        [0,1,2,3].map(c_ => M[4*r+c_].toFixed(4)).join(' ')).join('\\n')
      ).join('\\n\\n');
  }}
  draw();
}};
draw();
</script></body></html>
"""


def _jet_css(score: np.ndarray) -> list:
    """Per-point jet colormap -> css rgb() strings."""
    s = np.clip(np.asarray(score, np.float64), 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * s - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * s - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * s - 1), 0, 1)
    rgb = (np.stack([r, g, b], axis=1) * 255).astype(np.uint8)
    return [f"rgb({c[0]},{c[1]},{c[2]})" for c in rgb]


def export_interactive_viewer(path: str, points: np.ndarray,
                              scores: np.ndarray | None = None,
                              grasp_point_indices: np.ndarray | None = None,
                              frames_per_point: list | None = None,
                              max_points: int = 40000,
                              seed: int = 0) -> str:
    """Write a self-contained interactive viewer HTML.

    Args:
        points: (n, 3) cloud.
        scores: optional (n,) in [0, 1] — jet-colored (grey if absent).
        grasp_point_indices: (g,) indices of labeled points.
        frames_per_point: list of g arrays, each (k_i, 4, 4) local->global
            grasp poses for that point.
        max_points: clouds larger than this are subsampled for the HTML
            (labeled points are always kept).
    Returns: path written.
    """
    points = np.asarray(points, np.float64)
    n = points.shape[0]
    scores = (np.zeros(n) if scores is None
              else np.asarray(scores, np.float64))
    if grasp_point_indices is None:
        grasp_point_indices = np.zeros((0,), np.int64)
        frames_per_point = []
    grasp_point_indices = np.asarray(grasp_point_indices, np.int64)
    frames_per_point = [np.asarray(f, np.float64).reshape(-1, 4, 4)
                        for f in (frames_per_point or [])]
    assert len(frames_per_point) == len(grasp_point_indices)

    if n > max_points:
        rng = np.random.RandomState(seed)
        keep = np.zeros(n, bool)
        keep[rng.choice(n, max_points, replace=False)] = True
        keep[grasp_point_indices] = True
        remap = np.cumsum(keep) - 1
        points = points[keep]
        scores = scores[keep]
        grasp_point_indices = remap[grasp_point_indices]

    colors = (_jet_css(scores) if scores.any()
              else ["rgb(140,140,150)"] * len(points))
    data = {
        "points": np.round(points, 5).tolist(),
        "colors": colors,
        "labeled": grasp_point_indices.tolist(),
        "frames": [np.round(f.reshape(-1, 16), 6).tolist()
                   for f in frames_per_point],
        "gripper": np.round(_gripper_wireframe_segments(), 5).tolist(),
    }
    html = _HTML_TEMPLATE.format(data_json=json.dumps(data))
    with open(path, "w") as f:
        f.write(html)
    return path
