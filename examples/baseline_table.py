#!/usr/bin/env python
"""Reproduce BASELINE.md's comparison table end-to-end on this hardware.

For each batch size the reference recorded (stats/{single,16,32,64}:
solve-time mean/p50/p95/max and fig-8 tracking-error mean/p50/p95 at
N=64, dt=10 ms, true wrench [-60, 20, -40] N), run the same workload here
and print both side by side — the apples-to-apples artifact for "matches
or beats the reference's headline benchmarks".

Usage: python examples/baseline_table.py [ticks] [--json out.json]
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

# Reference values computed from /root/reference/stats/*/\*.npy (SURVEY.md
# section 6 / BASELINE.md).
REFERENCE = {
    1:  {"solve_us": (5261, 5265, 5868, 6692), "te": (0.192, 0.172, 0.388)},
    16: {"solve_us": (6376, 6313, 7141, 8388), "te": (0.150, 0.134, 0.296)},
    32: {"solve_us": (6755, 6738, 7346, 9407), "te": (0.139, 0.137, 0.242)},
    64: {"solve_us": (8964, 8982, 9681, 15700), "te": (0.125, 0.114, 0.239)},
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("ticks", nargs="?", type=int, default=1000)
    ap.add_argument("--json", default=None)
    ap.add_argument("--solve-iters", type=int, default=400)
    args = ap.parse_args()

    from indy7_mpc.utils.cache import enable_cache

    enable_cache()
    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc import reference, run_sampled_mpc
    from indy7_mpc.mpc.sampled import init_wrench_batch

    N, dt = 64, 0.01
    ticks = args.ticks
    model = indy7(dtype=jnp.float32)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    mpc_cfg = MPCConfig(N=N, dt=dt)

    from indy7_mpc.solvers.select import default_batch_solve_fn

    ref = reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=dt,
        cycles=10,
    )
    ref = reference.with_padding(ref, 200)
    x0 = jnp.zeros(12, jnp.float32)
    f_true = jnp.asarray([-60.0, 20.0, -40.0, 0, 0, 0], jnp.float32)
    key = jax.random.PRNGKey(42)

    rows = []
    for B in (1, 16, 32, 64):
        sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0,
                                  f_ext_resample_std=1.0)
        solve_fn = default_batch_solve_fn(model, cost_cfg, sqp_cfg, dt)

        # --- Solve-only latency (the unit the reference's solve_times
        # measure: one full batched SQP solve per control tick).
        wrench_b = init_wrench_batch(key, sample_cfg, jnp.float32)
        xs_b = jnp.zeros((B, 12), jnp.float32)
        goals_b = jnp.tile(ref[:N, :3].astype(jnp.float32), (B, 1, 1))
        X_b = jnp.zeros((B, N, 12), jnp.float32)
        U_b = jnp.zeros((B, N - 1, 6), jnp.float32)
        # Pipelined timing (block once per chunk): measures device time,
        # not the host<->device dispatch round trip, which is not on the
        # critical path of the device-resident closed loop.  Chunks must
        # be deep enough for the enqueue stream to hide the dispatch.
        jsolve = jax.jit(lambda *a: solve_fn(*a))
        out = jsolve(xs_b, goals_b, X_b, U_b, wrench_b)
        jax.block_until_ready(out.X)
        chunk = max(args.solve_iters // 4, 1)
        times = []
        Xw, Uw = out.X, out.U
        for _ in range(4):
            t0 = time.perf_counter()
            for _ in range(chunk):
                out = jsolve(xs_b, goals_b, Xw, Uw, wrench_b)
            jax.block_until_ready(out.X)
            times.append((time.perf_counter() - t0) / chunk * 1e6)
        times = np.asarray(times)

        # --- Closed-loop fig-8 tracking under the true wrench.
        run = jax.jit(
            lambda x0, key: run_sampled_mpc(
                model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg,
                x0, ref[: ticks + N], ticks, f_true, key,
                batch_solve_fn=solve_fn,
            )
        )
        _, trace = run(x0, key)  # compile + first run
        jax.block_until_ready(trace.tracking_error)
        t0 = time.perf_counter()
        _, trace = run(x0, key)
        jax.block_until_ready(trace.tracking_error)
        tick_us = (time.perf_counter() - t0) / ticks * 1e6
        te = np.asarray(trace.tracking_error)

        r = REFERENCE[B]
        rows.append({
            "B": B,
            "solve_us_mean": float(times.mean()),
            "solve_us_worst_chunk": float(times.max()),
            "closed_loop_tick_us": float(tick_us),
            "ref_solve_us_mean": r["solve_us"][0],
            "ref_solve_us_p95": r["solve_us"][2],
            "te_mean": float(te.mean()),
            "te_p50": float(np.percentile(te, 50)),
            "te_p95": float(np.percentile(te, 95)),
            "ref_te_mean": r["te"][0],
            "ref_te_p50": r["te"][1],
            "ref_te_p95": r["te"][2],
            "solves_per_sec": B / (times.mean() / 1e6),
            "ref_solves_per_sec": B / (r["solve_us"][0] / 1e6),
        })
        print(f"# B={B} done", file=sys.stderr)

    hdr = (f"{'B':>4} | {'solve us':>8} | {'tick us':>8} | "
           f"{'ref solve us':>12} | {'te mean/p50/p95':>22} | "
           f"{'ref te mean/p50/p95':>22} | {'solves/s':>9} | {'ref':>6}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(
            f"{r['B']:>4} | "
            f"{r['solve_us_mean']:>8.0f} | {r['closed_loop_tick_us']:>8.0f} | "
            f"{r['ref_solve_us_mean']:>12.0f} | "
            f"{r['te_mean']:>6.3f}/{r['te_p50']:>6.3f}/{r['te_p95']:>6.3f} | "
            f"{r['ref_te_mean']:>6.3f}/{r['ref_te_p50']:>6.3f}/"
            f"{r['ref_te_p95']:>6.3f} | "
            f"{r['solves_per_sec']:>9.0f} | {r['ref_solves_per_sec']:>6.0f}"
        )
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=2)
        print(f"# wrote {args.json}", file=sys.stderr)


if __name__ == "__main__":
    main()
