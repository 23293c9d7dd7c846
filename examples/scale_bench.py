#!/usr/bin/env python
"""Lane-scaling benchmark: batched SQP throughput vs batch size.

Covers the BASELINE.json scale configs (64 / 256 / 1024 / 4096 rollouts
on one GPU) with per-lane wrench hypotheses and warm-started solves, on
the production solver solvers/select.py picks.  The reference tops out
at a compile-time template of B=256 (gato_controller.py:53-63); here B
is a runtime axis.

Usage: python examples/scale_bench.py [N] [iters] [--mesh]

--mesh runs the SAME sweep through the lane-mesh sharded production path
(parallel.make_sharded_batch_solve: the production solver over a 1-D
mesh of every visible device).  Needs a
GPU; the device is printed on the first line.
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
    from indy7_mpc.utils.device import gpu_line

    print(json.dumps({"device": gpu_line()}))
    enable_cache()
    from indy7_mpc.config import CostConfig, SampleConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc.sampled import init_wrench_batch
    from indy7_mpc.solvers.select import default_batch_solve_fn

    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    use_mesh = "--mesh" in sys.argv[1:]
    N = int(argv[0]) if len(argv) > 0 else 32
    iters = int(argv[1]) if len(argv) > 1 else 2
    dt = 0.01
    model = indy7(dtype=jnp.float32)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=iters)
    key = jax.random.PRNGKey(42)

    mesh = None
    if use_mesh:
        from indy7_mpc.parallel import (
            make_lane_mesh, make_sharded_batch_solve,
        )

        mesh = make_lane_mesh()
        print(
            json.dumps({"mesh_devices": len(mesh.devices.flat)}),
        )

    results = []
    for B in (64, 256, 1024, 4096):
        w = init_wrench_batch(
            key, SampleConfig(batch_size=B, f_ext_std=20.0), jnp.float32
        )
        xs = jnp.zeros((B, 12), jnp.float32)
        goals = jnp.tile(jnp.asarray([0.35, 0.35, 0.6], jnp.float32),
                         (B, N, 1))
        X = jnp.zeros((B, N, 12), jnp.float32)
        U = jnp.zeros((B, N - 1, 6), jnp.float32)

        if use_mesh:
            f = make_sharded_batch_solve(
                model, cost_cfg, sqp_cfg, dt, mesh
            )
            # Commit inputs to the mesh ONCE (the deployed steady state:
            # warm starts/hypotheses live sharded on device between
            # ticks).  Passing uncommitted arrays into in_shardings
            # forces a reshard copy per call — measured 20x at B=4096.
            from indy7_mpc.parallel import shard_lanes

            xs, goals, X, U, w = shard_lanes(
                mesh, (xs, goals, X, U, w)
            )
        else:
            f = jax.jit(default_batch_solve_fn(model, cost_cfg, sqp_cfg, dt))
        r = f(xs, goals, X, U, w)
        jax.block_until_ready(r.X)
        reps = max(5, 2000 // max(B // 64, 1))
        t0 = time.perf_counter()
        for _ in range(reps):
            r = f(xs, goals, r.X, r.U, w)
        jax.block_until_ready(r.X)
        t = (time.perf_counter() - t0) / reps
        results.append(
            dict(
                B=B,
                us_per_batch=round(t * 1e6),
                solves_per_sec=round(B / t),
                finite=bool(np.all(np.isfinite(np.asarray(r.X)))),
            )
        )
        print(json.dumps(results[-1]))

    base = results[0]["solves_per_sec"] / 64
    for row in results:
        row["scaling_efficiency_vs_b64"] = round(
            row["solves_per_sec"] / row["B"] / base, 3
        )
    print(json.dumps({
        "N": N, "sqp_iters": iters,
        "sharded_mesh": None if mesh is None else len(mesh.devices.flat),
        "sweep": results,
    }))


if __name__ == "__main__":
    main()
