#!/usr/bin/env python
"""Reference-length closed-loop recordings with per-tick solve times.

Reproduces the reference's golden-data protocol (gato_controller.py:
270-295 + stats/): a 3,500-tick (35 s at 100 Hz) figure-8 closed loop per
batch size B in {1, 16, 32, 64}, recorded in the reference's exact
six-array .npy schema — but driven tick-by-tick through the runtime path
(SampledController.on_state), so every tick's ``solve_time_us`` is a real
host-measured latency (dispatch + B-lane solve + consensus +
resample), not a wall/ticks average.  That makes the p50/p95/max columns
directly comparable with the reference's recorded solve_times
(BASELINE.md rows 1-4).

Each batch size runs twice: against the NOMINAL plant (the controller's
own model, single RK4) and against the PERTURBED plant (config.
PERTURBED_PLANT: seeded ~±4% inertial error, joint friction, actuation
noise, 5x substeps) — the model-mismatch analog of the reference's
MuJoCo engine.  Run artifacts land in <out>/<tag>/ (default
chiprun_out/runs/, not committed) and a summary table in
<out>/RUNS.md, headed by the device it ran on.

Usage: python examples/record_runs.py [--ticks 3500] [--batches 1,16,32,64]
         [--plants nominal,perturbed] [--out chiprun_out/runs]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

# The reference sim's fixed initial pose (sim_node.cpp:196).
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]

REF_ROWS = {
    # BASELINE.md: solve-time (mean/p50/p95/max us), tracking (mean/p50/p95 m)
    1: ((5261, 5265, 5868, 6692), (0.192, 0.172, 0.388)),
    16: ((6376, 6313, 7141, 8388), (0.150, 0.134, 0.296)),
    32: ((6755, 6738, 7346, 9407), (0.139, 0.137, 0.242)),
    64: ((8964, 8982, 9681, 15700), (0.125, 0.114, 0.239)),
}


def spawn_plant_node(plant_cfg, dt, realtime_scale=1.0):
    """Build (if needed) and launch the native C++ plant process with the
    mismatch flags matching ``plant_cfg`` — the reference's actual
    topology: controller and plant in separate OS processes over a lossy
    latest-wins transport (gato_controller.py:163-167 <->
    sim_node.cpp:225-237), here UDP instead of DDS."""
    import subprocess

    root = os.path.join(os.path.dirname(__file__), "..")
    plant_dir = os.path.join(root, "native", "plant")
    exe = os.path.join(plant_dir, "plant_node")
    if not os.path.exists(exe):
        subprocess.run(["make", "-C", plant_dir, "plant_node"], check=True)
    substeps = plant_cfg.substeps if plant_cfg else 1
    cmd = [exe, str(dt / substeps), str(substeps)]
    if realtime_scale != 1.0:
        cmd += ["--realtime-scale", str(realtime_scale)]
    if plant_cfg is not None:
        if plant_cfg.param_scale_pct:
            cmd += ["--perturb", str(plant_cfg.param_scale_pct),
                    str(plant_cfg.seed)]
        if plant_cfg.viscous_friction or plant_cfg.coulomb_friction:
            cmd += ["--friction", str(plant_cfg.viscous_friction),
                    str(plant_cfg.coulomb_friction)]
        if plant_cfg.torque_noise_std:
            cmd += ["--noise", str(plant_cfg.torque_noise_std)]
    return subprocess.Popen(cmd, stdout=subprocess.DEVNULL)


def run_device_resident(model, B, ticks, plant_cfg, out_dir, tag,
                        chunk=100, mirror_port=None):
    """Device-resident recording: the ENTIRE closed loop (B-lane solve +
    consensus + resample + perturbed plant + reference advance) runs as
    jitted ``lax.scan`` chunks on the chip — the pure-JAX north-star mode
    (SURVEY.md section 7.9a) with no per-tick host dispatch.

    Per-tick ``solve_times`` are the measured wall time of each
    ``chunk``-tick dispatch divided by ``chunk`` — i.e. honest
    device-loop time per tick including the plant and consensus, amortized
    over the chunk; ``dts`` is the loop's sim-time control period (exactly
    ``dt`` — the device loop is not wall-clock gated).
    """
    import jax.numpy as jnp

    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.mpc import reference
    from indy7_mpc.mpc.sampled import init_loop_carry, make_loop_tick
    from indy7_mpc.runtime import RunRecorder

    N, dt = 64, 0.01
    dtype = jnp.float32
    chunk = max(1, min(chunk, ticks))  # short runs: don't overshoot 2x
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    mpc_cfg = MPCConfig(N=N, dt=dt)
    sample_cfg = SampleConfig(
        batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0
    )

    ref = reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=dt,
        cycles=max(10, (ticks + N) // 1000 + 1),
    )
    ref = jnp.asarray(
        np.asarray(reference.with_padding(ref, 200), np.float32)
    )

    tick = make_loop_tick(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref,
        f_true_walk=True, plant_cfg=plant_cfg,
    )

    @jax.jit
    def run_chunk(carry):
        return jax.lax.scan(tick, carry, None, length=chunk)

    t_init0 = time.perf_counter()
    x0 = jnp.zeros(12, dtype).at[:6].set(jnp.asarray(INIT_Q, dtype))
    carry = init_loop_carry(
        model, mpc_cfg, sample_cfg, x0,
        jnp.asarray([-60.0, 20.0, -40.0, 0, 0, 0], dtype),
        jax.random.PRNGKey(42),
    )
    carry_w, _ = run_chunk(carry)     # compile + warm up
    jax.block_until_ready(carry_w)
    init_s = time.perf_counter() - t_init0

    # Live-telemetry tap for the device-resident flagship mode: after
    # each chunk dispatch, replay the chunk's states onto the live_view
    # mirror port in the plant_node wire format (tools/live_view.py) —
    # the same viewer covers all three transports.
    mirror_sock = None
    if mirror_port:
        import socket as _socket

        mirror_sock = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
        mirror_addr = ("127.0.0.1", int(mirror_port))

    rec = RunRecorder(out_dir=os.path.join(out_dir, tag), save_interval=1e9)
    t0 = time.perf_counter()
    n_chunks = -(-ticks // chunk)  # ceil: cover the requested tick count
    sim_t = 0.0
    for _ in range(n_chunks):
        tc = time.perf_counter()
        carry, trace = run_chunk(carry)
        jax.block_until_ready(trace.tracking_error)
        per_tick_us = (time.perf_counter() - tc) / chunk * 1e6
        rec.record_trace(trace, dts=0.01, solve_times_us=per_tick_us)
        if mirror_sock is not None:
            xs = np.asarray(trace.x, "<f8")
            ees = np.asarray(trace.ee_pos, "<f8")
            for i in range(xs.shape[0]):
                sim_t += dt
                mirror_sock.sendto(
                    bytes([1]) + xs[i].tobytes() + ees[i].tobytes()
                    + np.asarray([sim_t], "<f8").tobytes(),
                    mirror_addr,
                )
    wall = time.perf_counter() - t0
    stem = rec.save()
    st = np.asarray(rec._data["solve_times"])
    te = np.asarray(rec._data["tracking_errors"])
    row = {
        "tag": tag,
        "B": B,
        "ticks": int(len(te)),
        "init_s": round(init_s, 1),
        "wall_s": round(wall, 1),
        "stem": stem,
        "first_tick_us": float(st[0]),
        "solve_us": [round(float(f), 1) for f in (
            st.mean(), np.percentile(st, 50), np.percentile(st, 95),
            st.max())],
        "tracking_m": [round(float(f), 4) for f in (
            te.mean(), np.percentile(te, 50), np.percentile(te, 95))],
        "finite": bool(np.all(np.isfinite(te))),
    }
    print(json.dumps(row))
    return row


def run_one(model, B, ticks, plant_cfg, out_dir, tag, transport="inproc",
            realtime_scale=1.0, mirror_port=None):
    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.mpc import reference
    from indy7_mpc.runtime import (
        InProcessPlant, RunRecorder, SampledController, run_control_loop,
    )

    N, dt = 64, 0.01
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    mpc_cfg = MPCConfig(N=N, dt=dt)
    sample_cfg = SampleConfig(
        batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0
    )

    # Reference run configuration (gato_controller.py:306-341).
    ref = reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=dt,
        cycles=10,
    )
    ref = reference.with_padding(ref, 200)

    t_init0 = time.perf_counter()
    ctl = SampledController(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref,
        f_ext_actual=[-60.0, 20.0, -40.0],
    )
    init_s = time.perf_counter() - t_init0
    proc = None
    if transport == "udp":
        from indy7_mpc.runtime import UdpTransport

        proc = spawn_plant_node(plant_cfg, dt, realtime_scale)
        plant = UdpTransport()
    else:
        # The reference sim's fixed initial pose (sim_node.cpp:196) — the
        # same state plant_node starts from; starting at zeros instead
        # drives joints 4/5 into their stops on the fig-8 approach.
        x0 = np.zeros(12)
        x0[:6] = INIT_Q
        plant = InProcessPlant(model, x0, dt, plant_cfg=plant_cfg,
                               mirror_port=mirror_port)

    rec = RunRecorder(out_dir=os.path.join(out_dir, tag), save_interval=1e9)
    t0 = time.perf_counter()
    try:
        rec = run_control_loop(
            ctl, plant, duration=1e9, rate_hz=100.0 / realtime_scale,
            recorder=rec, walk_disturbance=True,
            realtime=(transport == "udp"), max_ticks=ticks,
        )
    finally:
        plant.close()
        if proc is not None:
            proc.terminate()
            proc.wait(timeout=5)
    wall = time.perf_counter() - t0
    stem = rec.save()
    s = rec.summary()
    st = np.asarray(rec._data["solve_times"])
    te = np.asarray(rec._data["tracking_errors"])
    row = {
        "tag": tag,
        "B": B,
        "ticks": int(len(te)),
        "init_s": round(init_s, 1),
        "wall_s": round(wall, 1),
        "stem": stem,
        "first_tick_us": float(st[0]),
        "solve_us": [round(float(f), 1) for f in (
            st.mean(), np.percentile(st, 50), np.percentile(st, 95),
            st.max())],
        "tracking_m": [round(float(f), 4) for f in (
            te.mean(), np.percentile(te, 50), np.percentile(te, 95))],
        "finite": bool(np.all(np.isfinite(te))),
    }
    print(json.dumps(row))
    return row


def write_summary(rows, ticks, path):
    from indy7_mpc.utils.device import gpu_line

    lines = [
        "# Recorded closed-loop runs (this framework)",
        "",
        f"Produced by `python examples/record_runs.py --ticks {ticks}` on "
        f"{gpu_line()}; artifacts beside this file "
        "(reference six-array schema, gato_controller.py:288-293).",
        "",
        "Protocol: figure-8 (A_x=0.5, A_z=0.55, offset [0, 0.4, 0.45], "
        "period 10 s), N=64, dt=10 ms, true disturbance [-60, 20, -40] N "
        "walking every 200 steps, B wrench hypotheses (sigma=20, resample "
        "sigma=1) — the reference's recorded-run configuration "
        "(gato_controller.py:306-341).  Every tick is a real host "
        "dispatch through SampledController.on_state, so solve-time "
        "percentiles are honest per-tick latencies.",
        "",
        "`perturbed` rows run the plant with config.PERTURBED_PLANT "
        "(seeded ~±4% per-link inertial error, viscous+Coulomb joint "
        "friction, 0.1 N m actuation noise, 5x substeps) — model "
        "mismatch the controller does not know about, the role MuJoCo "
        "plays for the reference.",
        "",
        "| run | B | ticks | solve us mean/p50/p95/max | ref (us) | "
        "tracking m mean/p50/p95 | ref (m) | first tick us |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        ref_st, ref_te = REF_ROWS.get(r["B"], ((None,) * 4, (None,) * 3))
        st = "/".join(f"{v:,.0f}" for v in r["solve_us"])
        te = "/".join(f"{v:.3f}" for v in r["tracking_m"])
        rst = "/".join(f"{v:,}" for v in ref_st) if ref_st[0] else "n/a"
        rte = "/".join(f"{v:.3f}" for v in ref_te) if ref_te[0] else "n/a"
        lines.append(
            f"| {r['tag']} | {r['B']} | {r['ticks']} | {st} | {rst} | "
            f"{te} | {rte} | {r['first_tick_us']:,.0f} |"
        )
    lines += [
        "",
        "Reference columns: the CUDA solver's recorded 3,500-tick runs "
        "(stats/{single,16,32,64}, BASELINE.md).  Note the reference "
        "numbers are measured under MuJoCo model mismatch; compare them "
        "with the `perturbed` rows for like-for-like conditions.",
        "",
    ]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {path}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=3500)
    ap.add_argument("--batches", default="1,16,32,64")
    ap.add_argument("--plants", default="nominal,perturbed")
    ap.add_argument("--out", default=os.path.join("chiprun_out", "runs"))
    ap.add_argument(
        "--transport", default="inproc", choices=("inproc", "udp", "device"),
        help="udp = native C++ plant_node process over the UDP transport "
             "(the reference's two-process topology), wall-clock rate; "
             "device = fully device-resident lax.scan loop (no per-tick "
             "host dispatch — the pure-JAX north-star mode)",
    )
    ap.add_argument(
        "--realtime-scale", type=float, default=1.0,
        help="udp mode: run plant time N-times slower than wall clock "
             "(plant_node --realtime-scale) so the control rate in plant "
             "time matches the 100 Hz design rate on rigs whose dispatch "
             "latency exceeds the 10 ms budget.  The controller advances its "
             "reference by the plant's own sim clock either way.",
    )
    ap.add_argument("--no-summary", action="store_true",
                    help="skip writing <out>/RUNS.md")
    ap.add_argument("--mirror", type=int, default=None,
                    help="device mode: replay each chunk's states onto "
                         "this live_view mirror port (tools/live_view.py)")
    args = ap.parse_args()

    from indy7_mpc.utils.cache import enable_cache

    enable_cache()
    from indy7_mpc.config import PERTURBED_PLANT
    from indy7_mpc.models import indy7

    model = indy7(dtype=jnp.float32)
    rows = []
    for plant_name in args.plants.split(","):
        plant_cfg = PERTURBED_PLANT if plant_name == "perturbed" else None
        for B in [int(b) for b in args.batches.split(",")]:
            tag = f"{plant_name}_b{B}"
            if args.transport == "udp":
                tag += "_udp"
            elif args.transport == "device":
                tag += "_device"
            if args.transport == "device":
                rows.append(
                    run_device_resident(model, B, args.ticks, plant_cfg,
                                        args.out, tag,
                                        mirror_port=args.mirror)
                )
            else:
                rows.append(
                    run_one(model, B, args.ticks, plant_cfg, args.out, tag,
                            transport=args.transport,
                            realtime_scale=args.realtime_scale,
                            mirror_port=args.mirror)
                )
    if not args.no_summary:
        write_summary(rows, args.ticks, os.path.join(args.out, "RUNS.md"))


if __name__ == "__main__":
    main()
