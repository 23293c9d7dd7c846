#!/usr/bin/env python
"""Closed-loop figure-8 tracking benchmark (the reference's headline run).

Reproduces the configuration of the reference's recorded stats/
(gato_controller.py:306-341): N=64 horizon, dt=10ms, fig-8 with
A_x=0.5 / A_z=0.55 / offset [0, 0.4, 0.45] / period 10s, true disturbance
f_ext=[-60, 20, -40] N with a random walk, wrench-hypothesis batch with
sigma=20 / resample sigma=1 — but fully device-resident: the plant, the B
SQP solves (the production solver solvers/select.py picks), consensus,
and resampling run as one lax.scan.  Prints a stats summary comparable with BASELINE.md
(reference tracking error mean 0.125-0.192 m, solve 5.3-9.0 ms).

Usage: python examples/fig8_closed_loop.py [batch_size] [num_ticks]
         [--perturbed]

--perturbed runs the ground-truth plant with the standard model mismatch
(config.PERTURBED_PLANT: seeded ~±4% inertial error, joint friction,
actuation noise, 5x substeps) — the analog of the reference validating
against MuJoCo rather than its own linearization model.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    from indy7_mpc.utils.cache import enable_cache

    enable_cache()
    from indy7_mpc.config import (
        CostConfig, MPCConfig, PERTURBED_PLANT, SampleConfig, SQPConfig,
    )
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc import reference, run_sampled_mpc
    from indy7_mpc.runtime.stats import RunRecorder

    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    perturbed = "--perturbed" in sys.argv[1:]
    B = int(args[0]) if len(args) > 0 else 16
    ticks = int(args[1]) if len(args) > 1 else 1000
    N, dt = 64, 0.01

    model = indy7(dtype=jnp.float32)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    mpc_cfg = MPCConfig(N=N, dt=dt)
    sample_cfg = SampleConfig(
        batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0
    )

    # Reference trajectory with 200-tick padding (gato_controller.py:316-323).
    ref = reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=dt,
        cycles=10,
    )
    ref = reference.with_padding(ref, 200)

    # The reference sim's fixed initial pose (sim_node.cpp:196).
    x0 = jnp.zeros(12, jnp.float32).at[:6].set(jnp.asarray(
        [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190], jnp.float32
    ))
    f_true = jnp.asarray([-60.0, 20.0, -40.0, 0.0, 0.0, 0.0], jnp.float32)
    key = jax.random.PRNGKey(42)

    run = jax.jit(
        lambda x0, key: run_sampled_mpc(
            model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg,
            x0, ref[: ticks + N], ticks, f_true, key,
            plant_cfg=PERTURBED_PLANT if perturbed else None,
        )
    )
    t0 = time.time()
    final, trace = run(x0, key)
    jax.block_until_ready(trace.tracking_error)
    wall = time.time() - t0
    t0 = time.time()
    final, trace = run(x0, key)
    jax.block_until_ready(trace.tracking_error)
    wall = time.time() - t0

    te = np.asarray(trace.tracking_error)
    per_tick_us = wall / ticks * 1e6
    rec = RunRecorder(out_dir=os.path.join("chiprun_out", "fig8"))
    rec.record_trace(trace, dt, per_tick_us)
    stem = rec.save()
    summary = {
        "config": f"B={B} N={N} dt={dt} ticks={ticks}",
        "tracking_error_mean": float(te.mean()),
        "tracking_error_p50": float(np.percentile(te, 50)),
        "tracking_error_p95": float(np.percentile(te, 95)),
        # Skip the 200 padded warm-up ticks, like the reference's fig-8
        # region of interest.
        "tracking_error_mean_after_warmup": float(te[200:].mean())
        if ticks > 200 else None,
        "per_tick_us_incl_plant": per_tick_us,
        "realtime_ok": bool(per_tick_us < 10000),
        "stats_stem": stem,
        "reference_tracking_error_mean": {
            "batch1": 0.192, "batch16": 0.150, "batch32": 0.139,
            "batch64": 0.125,
        },
    }
    print(json.dumps(summary, indent=2))


if __name__ == "__main__":
    main()
