#!/usr/bin/env python
"""Live telemetry view of a running plant — the interactive-viewer role.

The reference's sim node renders the robot in a GLFW window while the
closed loop runs (/root/reference/src/sim/sim/sim_node.cpp:33-76,
350-365).  This framework's equivalent is headless-friendly: the native
plant duplicates its state packets to a mirror port
(``plant_node --mirror 7470``) and this tool renders them live —
a refreshing terminal dashboard (default) and/or a self-refreshing HTML
page with the 3-D end-effector trace (the offline counterpart is
tools/replay_html.py).

Usage:
    ./native/plant/plant_node 0.001 10 --mirror 7470 &
    python tools/live_view.py [--port 7470] [--html /tmp/live.html]
                              [--rate 5] [--duration 0]

With --html the page auto-reloads once a second; open it in any browser
(no server needed).  Ctrl-C (or --duration) exits.
"""
import argparse
import os
import socket
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

TAG_STATE = 1


def read_state(pkt):
    if len(pkt) < 1 + 15 * 8 or pkt[0] != TAG_STATE:
        return None
    vals = np.frombuffer(pkt[1:1 + 15 * 8], dtype="<f8")
    sim_time = None
    if len(pkt) >= 1 + 16 * 8:
        sim_time = float(
            np.frombuffer(pkt[1 + 15 * 8:1 + 16 * 8], dtype="<f8")[0]
        )
    return vals[:6], vals[6:12], vals[12:15], sim_time


def render_terminal(q, v, ee, sim_time, hz, trail):
    bar = lambda x, lim: "#" * int(min(abs(x) / lim, 1.0) * 20)
    lines = [
        "indy7 live view  "
        f"(sim t = {sim_time:.2f} s, {hz:.0f} state pkts/s)"
        if sim_time is not None else "indy7 live view",
        f"  EE  x={ee[0]:+.3f}  y={ee[1]:+.3f}  z={ee[2]:+.3f}  m   "
        f"(trail {len(trail)} pts)",
    ]
    for i in range(6):
        lines.append(
            f"  q{i} {q[i]:+7.3f} rad |{bar(q[i], 3.75):<20}| "
            f"v{i} {v[i]:+6.2f} rad/s"
        )
    sys.stdout.write("\x1b[2J\x1b[H" + "\n".join(lines) + "\n")
    sys.stdout.flush()


def write_html(path, trail, sim_time):
    pts = np.asarray(trail[-2000:])
    if pts.size == 0:
        return
    lo, hi = pts.min(axis=0), pts.max(axis=0)
    c, span = (lo + hi) / 2, max(float((hi - lo).max()), 1e-3)

    def proj(p):  # simple isometric projection
        x, y, z = (p - c) / span
        return 300 + 260 * (x - y) * 0.7, 300 - 260 * (z - (x + y) * 0.35)

    d = "M" + " L".join(f"{px:.1f},{py:.1f}" for px, py in map(proj, pts))
    ex, ey = proj(pts[-1])
    html = f"""<!doctype html><meta http-equiv="refresh" content="1">
<title>indy7 live</title>
<body style="background:#111;color:#ddd;font:13px system-ui">
<p>live EE trace — sim t = {sim_time if sim_time is not None else '?'} s
({len(trail)} points)</p>
<svg width="600" height="600" style="background:#181818">
<path d="{d}" fill="none" stroke="#4af" stroke-width="1.2"/>
<circle cx="{ex:.1f}" cy="{ey:.1f}" r="5" fill="#fa4"/>
</svg></body>"""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(html)
    os.replace(tmp, path)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=7470)
    ap.add_argument("--html", default=None,
                    help="also write a self-refreshing HTML page here")
    ap.add_argument("--rate", type=float, default=5.0,
                    help="terminal refresh rate (Hz)")
    ap.add_argument("--duration", type=float, default=0.0,
                    help="exit after this many seconds (0 = run forever)")
    ap.add_argument("--quiet", action="store_true",
                    help="no terminal dashboard (HTML only)")
    args = ap.parse_args()

    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", args.port))
    sock.settimeout(0.5)

    trail = []
    t_start = time.time()
    t_draw = 0.0
    n_pkts = 0
    t_rate = time.time()
    hz = 0.0
    try:
        while True:
            if args.duration and time.time() - t_start > args.duration:
                break
            try:
                pkt, _ = sock.recvfrom(512)
            except socket.timeout:
                continue
            st = read_state(pkt)
            if st is None:
                continue
            q, v, ee, sim_time = st
            trail.append(ee.copy())
            n_pkts += 1
            now = time.time()
            if now - t_rate >= 1.0:
                hz = n_pkts / (now - t_rate)
                n_pkts, t_rate = 0, now
            if now - t_draw >= 1.0 / args.rate:
                t_draw = now
                if not args.quiet:
                    render_terminal(q, v, ee, sim_time, hz, trail)
                if args.html:
                    write_html(args.html, trail, sim_time)
    except KeyboardInterrupt:
        pass
    finally:
        sock.close()
    print(f"\nlive_view: {len(trail)} states observed")


if __name__ == "__main__":
    main()
