#!/usr/bin/env python
"""Decompose the host-path control tick latency on one GPU.

A host-driven tick (runtime/controller.py) pays dispatch + compute +
fetch against a 10 ms control budget.  This tool attributes it with five
direct measurements at the production config (B=64, N=64, 2 SQP iters):

  null_rtt      blocking round trip of a jitted no-op (dispatch floor:
                what ANY blocking host->device->host call costs here);
  fetch_rtt     device_get of a tiny ready array (transfer path only);
  solve_device  per-solve time of a device-chained fori_loop of solves
                (pure device compute, no host in the loop);
  solve_block   one full batched solve per host call, block_until_ready
                every call (what a real-time external-plant tick pays);
  tick_block    SampledController.on_state — solve + consensus +
                resample + the single synchronizing fetch.

It also hunts stalls: runs a closed on_state loop with compile logging
on and reports every tick above --stall-ms with whether a JIT compile
fired during it.

Writes --out (default chiprun_out/LATENCY.md, not committed) and prints
one JSON line.  Needs a GPU; the device heads both.

Usage: python tools/latency_decomp.py [--ticks 600] [--stall-ms 100]
"""
import argparse
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def pct(a, q):
    return float(np.percentile(np.asarray(a), q))


def bench_loop(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e6)
    return np.asarray(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--stall-ms", type=float, default=100.0)
    ap.add_argument("--B", type=int, default=64)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "LATENCY.md"))
    args = ap.parse_args()

    from indy7_mpc.utils.cache import enable_cache
    from indy7_mpc.utils.device import gpu_line

    device = gpu_line()
    print(f"# {device}", file=sys.stderr)
    enable_cache()
    from indy7_mpc.config import (
        CostConfig, MPCConfig, PERTURBED_PLANT, SampleConfig, SQPConfig,
    )
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc import reference
    from indy7_mpc.mpc.sampled import init_wrench_batch
    from indy7_mpc.runtime import (
        InProcessPlant, SampledController, run_control_loop,
    )
    from indy7_mpc.solvers.select import default_batch_solve_fn

    B, N, dt = args.B, args.N, 0.01
    dev = jax.devices()[0]
    model = indy7(dtype=jnp.float32)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    solve_fn = default_batch_solve_fn(model, cost_cfg, sqp_cfg, dt)

    # --- 1. dispatch floor: blocking no-op round trip.
    noop = jax.jit(lambda x: x + 1.0)
    x1 = jnp.zeros((), jnp.float32)
    null_rtt = bench_loop(
        lambda: jax.block_until_ready(noop(x1)), 50
    )

    # --- 2. transfer path: fetch a tiny READY array.
    small = jax.block_until_ready(jnp.zeros(8, jnp.float32))
    fetch_rtt = bench_loop(lambda: jax.device_get(small), 50)

    # --- 3-5. solve at the production config.
    key = jax.random.PRNGKey(42)
    wrench_b = init_wrench_batch(
        key, SampleConfig(batch_size=B, f_ext_std=20.0), jnp.float32
    )
    xs_b = jnp.zeros((B, 12), jnp.float32)
    goals_b = jnp.tile(jnp.asarray([0.35, 0.35, 0.6], jnp.float32), (B, N, 1))
    X_b = jnp.zeros((B, N, 12), jnp.float32)
    U_b = jnp.zeros((B, N - 1, 6), jnp.float32)

    jsolve = jax.jit(lambda *a: solve_fn(*a))
    res = jax.block_until_ready(jsolve(xs_b, goals_b, X_b, U_b, wrench_b))
    Xw, Uw = res.X, res.U

    R = 20

    @jax.jit
    def chain(XU):
        def body(_, XU):
            r = solve_fn(xs_b, goals_b, XU[0], XU[1], wrench_b)
            return r.X, r.U

        return jax.lax.fori_loop(0, R, body, XU)

    out = jax.block_until_ready(chain((Xw, Uw)))
    t0 = time.perf_counter()
    for _ in range(5):
        out = chain(out)
    jax.block_until_ready(out)
    solve_device_us = (time.perf_counter() - t0) / (5 * R) * 1e6

    solve_block = bench_loop(
        lambda: jax.block_until_ready(jsolve(xs_b, goals_b, Xw, Uw, wrench_b)),
        30,
    )

    pend = [jsolve(xs_b, goals_b, Xw, Uw, wrench_b) for _ in range(3)]
    t0 = time.perf_counter()
    pend = [jsolve(xs_b, goals_b, Xw, Uw, wrench_b) for _ in range(30)]
    jax.block_until_ready(pend[-1])
    solve_pipelined_us = (time.perf_counter() - t0) / 30 * 1e6

    # --- 6. full controller tick.
    ref = reference.with_padding(
        reference.figure8(0.5, 0.55, [0.0, 0.4, 0.45], 10, dt, 10), 200
    )
    ctl = SampledController(
        model, cost_cfg, sqp_cfg, MPCConfig(N=N, dt=dt),
        SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0),
        ref, f_ext_actual=[-60.0, 20.0, -40.0],
    )
    x0 = np.zeros(12, np.float32)
    tick_block = bench_loop(lambda: ctl.on_state(x0, dt), 30)

    # --- 7. stall hunt: closed loop with compile logging captured.
    compile_events = []

    class _H(logging.Handler):
        def emit(self, record):
            compile_events.append((time.perf_counter(), record.getMessage()))

    h = _H()
    logger = logging.getLogger("jax._src.dispatch")
    jax.config.update("jax_log_compiles", True)
    logger.addHandler(h)

    ctl2 = SampledController(
        model, cost_cfg, sqp_cfg, MPCConfig(N=N, dt=dt),
        SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0),
        ref, f_ext_actual=[-60.0, 20.0, -40.0],
    )
    plant = InProcessPlant(
        model, np.zeros(12), dt, plant_cfg=PERTURBED_PLANT
    )
    stalls = []
    tick_times = []
    t_loop0 = time.perf_counter()
    rec = run_control_loop(
        ctl2, plant, duration=1e9, rate_hz=100, walk_disturbance=True,
        realtime=False, max_ticks=args.ticks,
    )
    tick_times = np.asarray(rec._data["solve_times"])
    jax.config.update("jax_log_compiles", False)
    logger.removeHandler(h)
    thresh_us = args.stall_ms * 1e3
    stall_idx = np.nonzero(tick_times > thresh_us)[0]
    stalls = [
        {"tick": int(i), "us": float(tick_times[i])} for i in stall_idx
    ]
    # Compile events that fired after the loop started => retracing stalls.
    loop_compiles = [m for (t, m) in compile_events if t > t_loop0]

    report = {
        "device": device,
        "platform": dev.platform,
        "config": f"B={B} N={N} iters=2",
        "null_rtt_us": {"p50": pct(null_rtt, 50), "p95": pct(null_rtt, 95)},
        "fetch_rtt_us": {"p50": pct(fetch_rtt, 50), "p95": pct(fetch_rtt, 95)},
        "solve_device_us": round(solve_device_us, 1),
        "solve_pipelined_us": round(solve_pipelined_us, 1),
        "solve_block_us": {
            "p50": pct(solve_block, 50), "p95": pct(solve_block, 95),
        },
        "tick_block_us": {
            "p50": pct(tick_block, 50), "p95": pct(tick_block, 95),
        },
        "loop_ticks": int(len(tick_times)),
        "loop_tick_us": {
            "p50": pct(tick_times, 50), "p95": pct(tick_times, 95),
            "max": float(tick_times.max()),
        },
        "stalls_over_thresh": stalls[:20],
        "compiles_during_loop": len(loop_compiles),
    }
    print(json.dumps(report))

    attribution = (
        report["tick_block_us"]["p50"]
        - report["null_rtt_us"]["p50"]
        - report["fetch_rtt_us"]["p50"]
        - solve_device_us
    )
    lines = [
        "# LATENCY — per-tick control latency decomposition",
        "",
        f"Measured by `python tools/latency_decomp.py` on {device}, "
        f"config B={B} N={N}, 2 SQP iterations.",
        "",
        "| quantity | p50 | p95 |",
        "|---|---|---|",
        f"| jitted no-op, blocking round trip | "
        f"{report['null_rtt_us']['p50']:,.0f} us | "
        f"{report['null_rtt_us']['p95']:,.0f} us |",
        f"| device_get of a ready 8-float array | "
        f"{report['fetch_rtt_us']['p50']:,.0f} us | "
        f"{report['fetch_rtt_us']['p95']:,.0f} us |",
        f"| full solve, device-chained (device compute) | "
        f"{solve_device_us:,.0f} us | — |",
        f"| full solve, pipelined enqueue | "
        f"{solve_pipelined_us:,.0f} us | — |",
        f"| full solve, blocking each call | "
        f"{report['solve_block_us']['p50']:,.0f} us | "
        f"{report['solve_block_us']['p95']:,.0f} us |",
        f"| controller tick (on_state: solve+consensus+fetch) | "
        f"{report['tick_block_us']['p50']:,.0f} us | "
        f"{report['tick_block_us']['p95']:,.0f} us |",
        f"| closed-loop tick incl. plant ({len(tick_times)} ticks) | "
        f"{report['loop_tick_us']['p50']:,.0f} us | "
        f"{report['loop_tick_us']['p95']:,.0f} us "
        f"(max {report['loop_tick_us']['max']:,.0f}) |",
        "",
        "## Attribution",
        "",
        f"A blocking tick pays the dispatch round "
        f"trip (~{report['null_rtt_us']['p50']/1e3:,.1f} ms for a no-op) "
        f"plus the result fetch "
        f"(~{report['fetch_rtt_us']['p50']/1e3:,.1f} ms) before any "
        f"compute; device compute itself is {solve_device_us/1e3:,.2f} ms "
        f"per solve.  Residual host-side work in on_state: "
        f"~{max(attribution, 0)/1e3:,.1f} ms.",
        "",
        f"The device-resident closed loop (everything in one lax.scan — "
        f"the pure-JAX mode) avoids the round trip entirely and runs at "
        f"{solve_device_us/1e3:,.2f} ms/tick device time.",
        "",
        "## Stall hunt",
        "",
        f"{args.ticks}-tick perturbed closed loop with JIT compile "
        f"logging: {len(stalls)} ticks over {args.stall_ms:.0f} ms; "
        f"{len(loop_compiles)} JIT compiles fired during the loop "
        + ("(stalls are retracing!)." if loop_compiles and stalls else
           "(no retracing — stalls, when present, are host "
           "hiccups, not recompiles)."),
        "",
    ]
    if stalls:
        lines += [
            "Stall ticks (first 20): "
            + ", ".join(f"#{s['tick']}={s['us']/1e3:,.0f}ms"
                        for s in stalls[:20]),
            "",
        ]
    with open(args.out, "w") as f:
        f.write("\n".join(lines))
    print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
