#!/usr/bin/env python
"""Point-to-goal MPC demo (the pin_mpc_indy7 / gato_mpc_indy7 notebooks).

Drives the EE through a chain of FK-derived goal points with the
receding-horizon MPC loop, entirely on device.  With --compare it also
runs the batch-1-vs-batch-B disturbance study of
notebooks/gato_mpc_indy7_sample.ipynb: both controllers track a constant
reference under an unmodeled wrench f_ext=[5, 0, 15] N; the sampled
controller should hold a smaller goal distance.

Usage: python examples/point_to_goal.py [--compare] [--steps 300]
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--compare", action="store_true")
    args = ap.parse_args()

    from indy7_mpc.utils.cache import enable_cache

    enable_cache()
    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.dynamics import ee_pos
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc import run_mpc, run_sampled_mpc

    model = indy7(dtype=jnp.float32)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=3)
    mpc_cfg = MPCConfig(N=32, dt=0.01)

    x0 = jnp.zeros(12, jnp.float32)
    ee0 = np.asarray(ee_pos(model, x0[:6]))
    # FK-derived goal chain (the notebooks sample FK at joint offsets).
    goals = np.stack([
        ee0 + [0.10, -0.10, -0.10],
        ee0 + [-0.15, 0.05, -0.20],
        ee0 + [0.05, 0.15, -0.05],
    ])

    t0 = time.time()
    final, trace = jax.jit(
        lambda x0: run_mpc(
            model, cost_cfg, sqp_cfg, mpc_cfg, x0, goals, args.steps,
        )
    )(x0)
    jax.block_until_ready(trace.goal_dist)
    d = np.asarray(trace.goal_dist)
    out = {
        "mode": "point_to_goal",
        "steps": args.steps,
        "initial_dist": float(d[0]),
        "final_dist": float(d[-1]),
        "min_dist": float(d.min()),
        "goal_switches": int((np.diff(np.asarray(trace.goal_idx)) != 0).sum()),
        "wall_s": time.time() - t0,
    }
    print(json.dumps(out, indent=2))

    if args.compare:
        f_true = jnp.asarray([5.0, 0.0, 15.0, 0, 0, 0], jnp.float32)
        ref = np.tile(goals[0], (args.steps + mpc_cfg.N, 1)).astype(np.float32)
        key = jax.random.PRNGKey(42)
        results = {}
        for B in (1, 64):
            scfg = SampleConfig(
                batch_size=B,
                f_ext_std=0.0 if B == 1 else 15.0,
                f_ext_resample_std=0.0 if B == 1 else 1.0,
            )
            _, tr = jax.jit(
                lambda x0, key, scfg=scfg: run_sampled_mpc(
                    model, cost_cfg, sqp_cfg, mpc_cfg, scfg,
                    x0, ref, args.steps, f_true, key, f_true_walk=False,
                )
            )(x0, key)
            te = np.asarray(tr.tracking_error)
            results[f"batch{B}"] = {
                "tracking_error_mean": float(te.mean()),
                "tracking_error_tail": float(te[-50:].mean()),
                "f_est_final": np.asarray(tr.f_est)[-1, :3].round(2).tolist(),
            }
        print(json.dumps({"mode": "sampled_comparison",
                          "f_true": [5.0, 0.0, 15.0],
                          **results}, indent=2))


if __name__ == "__main__":
    main()
