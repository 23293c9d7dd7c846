#!/usr/bin/env python
"""Interactive HTML replay of a recorded closed-loop run.

The counterpart of the reference's Meshcat joint-trajectory
replay (notebooks/stat_analysis.ipynb last cells): loads a stats
directory in the reference six-array schema (gato_controller.py:288-293),
reconstructs the robot's link positions per frame with the framework's
own forward kinematics, and writes ONE self-contained HTML file — a 3-D
stick-figure animation with the commanded figure-8 reference, the
achieved EE trace, play/pause/scrub, and drag-to-orbit — viewable in any
browser with no server or dependency.

Usage: python tools/replay_html.py stats/perturbed_b64
         [--stem HHMMSS] [--every 4] [--out replay.html]
"""
import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Host-side viz tool: a few thousand FK evaluations need no accelerator,
# and staying on the CPU leaves the card to the controller process (must
# be set before jax import; see tests/conftest.py).
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np

TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>indy7-mpc replay</title>
<style>
 body {{ margin:0; background:#14171c; color:#cfd6e1;
        font:13px system-ui, sans-serif; }}
 #hud {{ position:fixed; top:10px; left:12px; }}
 #bar {{ position:fixed; bottom:10px; left:12px; right:12px;
        display:flex; gap:10px; align-items:center; }}
 #scrub {{ flex:1; }}
 canvas {{ display:block; width:100vw; height:100vh; }}
 button {{ background:#2a3140; color:#cfd6e1; border:1px solid #3c4557;
          border-radius:4px; padding:4px 12px; cursor:pointer; }}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud">{title}<br><span id="t"></span></div>
<div id="bar"><button id="play">pause</button>
<input id="scrub" type="range" min="0" max="{maxframe}" value="0"></div>
<script>
const DATA = {data};
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let frame = 0, playing = true, yaw = -0.9, pitch = 0.35, dist = 2.2;
const center = [0, 0.25, 0.45];
function resize() {{ cv.width = innerWidth; cv.height = innerHeight; }}
addEventListener('resize', resize); resize();
let dragging = false, px = 0, py = 0;
cv.addEventListener('mousedown', e => {{ dragging = true; px = e.clientX; py = e.clientY; }});
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {{
  if (!dragging) return;
  yaw += (e.clientX - px) * 0.008; pitch += (e.clientY - py) * 0.008;
  pitch = Math.max(-1.4, Math.min(1.4, pitch)); px = e.clientX; py = e.clientY;
}});
cv.addEventListener('wheel', e => {{ dist *= Math.exp(e.deltaY * 0.001); }});
function proj(p) {{
  const x = p[0] - center[0], y = p[1] - center[1], z = p[2] - center[2];
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cy * x + sy * y, y1 = -sy * x + cy * y;
  const y2 = cp * y1 - sp * z, z2 = sp * y1 + cp * z;
  const s = Math.min(cv.width, cv.height) / dist;
  return [cv.width / 2 + x1 * s, cv.height / 2 - z2 * s, y2];
}}
function polyline(pts, color, width, closeAlpha) {{
  ctx.strokeStyle = color; ctx.lineWidth = width; ctx.beginPath();
  for (let i = 0; i < pts.length; i++) {{
    const q = proj(pts[i]);
    if (i === 0) ctx.moveTo(q[0], q[1]); else ctx.lineTo(q[0], q[1]);
  }}
  ctx.globalAlpha = closeAlpha ?? 1; ctx.stroke(); ctx.globalAlpha = 1;
}}
function draw() {{
  ctx.clearRect(0, 0, cv.width, cv.height);
  // ground grid
  for (let i = -5; i <= 5; i++) {{
    polyline([[i * 0.2, -1, 0], [i * 0.2, 1, 0]], '#232a36', 1);
    polyline([[-1, i * 0.2, 0], [1, i * 0.2, 0]], '#232a36', 1);
  }}
  polyline(DATA.ref, '#5aa9e6', 1.5, 0.8);          // commanded figure-8
  polyline(DATA.ee.slice(0, frame + 1), '#f2a65a', 1.5, 0.9); // achieved
  const links = DATA.links[frame];
  polyline(links, '#e8edf5', 4);
  for (const p of links) {{
    const q = proj(p); ctx.fillStyle = '#9fb4d0';
    ctx.beginPath(); ctx.arc(q[0], q[1], 4, 0, 7); ctx.fill();
  }}
  const ee = proj(DATA.ee[frame]); ctx.fillStyle = '#f2a65a';
  ctx.beginPath(); ctx.arc(ee[0], ee[1], 6, 0, 7); ctx.fill();
  const rf = proj(DATA.refpt[frame]); ctx.strokeStyle = '#5aa9e6';
  ctx.beginPath(); ctx.arc(rf[0], rf[1], 7, 0, 7); ctx.stroke();
  document.getElementById('t').textContent =
    't = ' + (frame * DATA.dt).toFixed(2) + ' s   tracking err = ' +
    DATA.err[frame].toFixed(3) + ' m';
  document.getElementById('scrub').value = frame;
}}
function tick() {{
  if (playing) frame = (frame + 1) % DATA.links.length;
  draw(); requestAnimationFrame(tick);
}}
document.getElementById('play').onclick = function () {{
  playing = !playing; this.textContent = playing ? 'pause' : 'play';
}};
document.getElementById('scrub').oninput = function () {{
  frame = +this.value; playing = false;
  document.getElementById('play').textContent = 'play';
}};
tick();
</script></body></html>
"""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("stats_dir")
    ap.add_argument("--stem", default=None)
    ap.add_argument("--every", type=int, default=4,
                    help="keep every k-th tick (4 -> 25 fps at 100 Hz)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    stems = sorted(
        os.path.basename(f).split("_")[0]
        for f in glob.glob(os.path.join(args.stats_dir, "*_dts.npy"))
    )
    if not stems:
        sys.exit(f"no recordings in {args.stats_dir}")
    stem = args.stem or stems[-1]

    def load(name):
        return np.load(os.path.join(args.stats_dir, f"{stem}_{name}.npy"))

    q = load("joint_positions")[:: args.every]
    ee = load("ee_positions")[:: args.every]
    ref = load("ee_ref_positions")[:: args.every]
    err = load("tracking_errors")[:: args.every]
    dt = float(np.mean(load("dts"))) * args.every

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from indy7_mpc.dynamics.kinematics import joint_frames
    from indy7_mpc.models import indy7

    model = indy7(dtype=jnp.float32)
    _, p = jax.vmap(lambda qq: joint_frames(model, qq))(
        jnp.asarray(q, jnp.float32)
    )
    base = np.zeros((p.shape[0], 1, 3), np.float32)
    links = np.concatenate([base, np.asarray(p)], axis=1)

    r3 = lambda a: np.round(np.asarray(a, float), 4).tolist()
    data = {
        "dt": dt,
        "links": r3(links),
        "ee": r3(ee),
        "refpt": r3(ref),
        "ref": r3(ref[:: max(1, len(ref) // 600)]),
        "err": np.round(np.asarray(err, float), 4).tolist(),
    }
    out = args.out or os.path.join(
        args.stats_dir, f"{stem}_replay.html"
    )
    title = (f"indy7-mpc replay — {os.path.basename(args.stats_dir)}"
             f"/{stem} ({len(links)} frames, every {args.every} ticks)")
    with open(out, "w") as f:
        f.write(TEMPLATE.format(
            data=json.dumps(data), title=title, maxframe=len(links) - 1,
        ))
    print(f"wrote {out} ({os.path.getsize(out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
