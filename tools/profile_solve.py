#!/usr/bin/env python
"""Time the batched SQP solve on the GPU: the two plain XLA solvers.

  lane    solvers/sqp_lane.py    (lane-major; the GPU production solver)
  vmap    solvers/sqp.py         (the readable vmap solver, float32)

Usage:
  python tools/profile_solve.py [--backend lane vmap] [--B 1 64 4096]
      [--N 32 64] [--iters 20] [--check]

Each row is the median of ``--iters`` blocking solves (host clock around
``block_until_ready``; 2 SQP iterations, warm-started random problem,
wrench hypotheses on), after one compiling call whose time is reported
separately.  ``--check`` also replays three lanes of each row through the
float64 CPU oracle (solvers/replay.py) and reports the worst error.
Rows are appended as JSON lines to ``--out``.  Needs a GPU.
"""
import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def problem(B, N, seed=11):
    """Random warm-started lanes with wrench hypotheses (float32)."""
    rng = np.random.default_rng(seed)
    f = lambda a: jnp.asarray(a, jnp.float32)
    xs = f(rng.normal(size=(B, 12)) * 0.05)
    goals = f(rng.normal(size=(B, N, 3)) * 0.3)
    X = f(rng.normal(size=(B, N, 12)) * 0.05)
    U = f(rng.normal(size=(B, N - 1, 6)) * 0.5)
    w = f(rng.normal(size=(B, 6)) * 8).at[:, 3:].set(0.0)
    return xs, goals, X, U, w


def oracle_error(model, cost_cfg, sqp_cfg, dt, a, res):
    from indy7_mpc.solvers.replay import lane_error, replay_lane

    B = a[0].shape[0]
    errs = []
    for lane in sorted({0, B // 2, B - 1}):
        X_e, U_e, _ = replay_lane(
            model, cost_cfg, sqp_cfg, dt, a[0][lane], a[1][lane], a[2][lane],
            a[3][lane], a[4][lane], np.asarray(res.stats.alphas[lane]),
            sqp_cfg.rho,
        )
        errs.append(lane_error(res.X[lane], res.U[lane], X_e, U_e))
    return max(errs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", nargs="+", default=["lane", "vmap"],
                    choices=["lane", "vmap"])
    ap.add_argument("--B", nargs="+", type=int, default=[1, 64, 4096])
    ap.add_argument("--N", nargs="+", type=int, default=[32, 64])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default="chiprun_out/profile_solve.jsonl")
    args = ap.parse_args()

    from indy7_mpc.config import CostConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.solvers import sqp, sqp_lane
    from indy7_mpc.utils.cache import enable_cache
    from indy7_mpc.utils.device import gpu_line

    device = gpu_line()
    print("#", device, flush=True)
    enable_cache()
    model = indy7(dtype=jnp.float32)
    cost_cfg, sqp_cfg, dt = CostConfig(), SQPConfig(max_iters=2), 0.01
    mods = {"lane": sqp_lane, "vmap": sqp}

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    print(f"{'backend':<8} {'N':>3} {'B':>5} {'compile s':>9} "
          f"{'median us':>10} {'min us':>9} {'solves/s':>10} {'oracle':>9}")
    for N in args.N:
        for B in args.B:
            a = problem(B, N)
            for backend in args.backend:
                mod = mods[backend]
                solve = jax.jit(lambda *a: mod.batch_solve(
                    model, cost_cfg, sqp_cfg, dt, *a[:4],
                    wrench_world_batch=a[4],
                ))
                t0 = time.perf_counter()
                res = jax.block_until_ready(solve(*a))
                t_c = time.perf_counter() - t0
                ts = []
                for _ in range(args.iters):
                    t0 = time.perf_counter()
                    jax.block_until_ready(solve(*a))
                    ts.append(time.perf_counter() - t0)
                med, lo = statistics.median(ts), min(ts)
                err = (oracle_error(model, cost_cfg, sqp_cfg, dt, a, res)
                       if args.check else None)
                print(f"{backend:<8} {N:>3} {B:>5} {t_c:>9.1f} "
                      f"{med * 1e6:>10.1f} {lo * 1e6:>9.1f} "
                      f"{B / med:>10.0f} "
                      f"{'-' if err is None else f'{err:.2e}':>9}",
                      flush=True)
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(dict(
                        device=device, backend=backend, N=N, B=B,
                        compile_s=t_c, median_us=med * 1e6,
                        min_us=lo * 1e6, oracle_error=err,
                        times_us=[t * 1e6 for t in ts],
                    )) + "\n")


if __name__ == "__main__":
    main()
