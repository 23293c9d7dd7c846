"""Benchmark: batched SQP-MPC solves/s on one GPU.

Prints the device on stderr and ONE JSON line on stdout:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}

Baseline: the reference's recorded batch-64 closed-loop solve times at
horizon N=64 (stats/64/041825_solve_times.npy, mean 8964 us => 7140
solves/s implied throughput; BASELINE.md).  The headline metric is
measured at the SAME config — B=64, N=64, 2 SQP iterations — so
``vs_baseline`` is apples-to-apples.  A secondary N=32 line (the
north-star config, BASELINE.json: >= 1000 solves/s at horizon 32) is
printed to stderr.

The benchmarked unit of work is one full control-tick solve: a complete
SQP solve (linearize -> batched Riccati -> 8-alpha merit line search,
2 iterations) for each of B=64 lanes with per-lane wrench hypotheses —
the same work ``bindings.batch_sqp.SQPSolverfloat_64.solve`` performs
(gato_controller.py:93-103) — on the production solver that
solvers/select.py picks for the device.  Needs a GPU.
"""
import json
import sys
import time

import jax
import jax.numpy as jnp

REF_SOLVES_PER_SEC = 7140.0  # reference B=64/N=64 implied throughput


def measure(B, N, dt=0.01):
    """(chained_us_per_solve, dispatch_us_per_solve) for one config."""
    from indy7_mpc.config import CostConfig, SampleConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc.sampled import init_wrench_batch
    from indy7_mpc.solvers.select import default_batch_solve_fn

    dtype = jnp.float32
    model = indy7(dtype=dtype)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)

    key = jax.random.PRNGKey(42)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0)
    wrench_b = init_wrench_batch(key, sample_cfg, dtype)

    batch_solve = default_batch_solve_fn(model, cost_cfg, sqp_cfg, dt)
    xs_b = jnp.zeros((B, 12), dtype)
    goal = jnp.asarray([0.35, 0.35, 0.6], dtype)
    goals_b = jnp.tile(goal, (B, N, 1))
    X_b = jnp.zeros((B, N, 12), dtype)
    U_b = jnp.zeros((B, N - 1, 6), dtype)

    @jax.jit
    def solve(xs_b, goals_b, X_b, U_b, wrench_b):
        res = batch_solve(xs_b, goals_b, X_b, U_b, wrench_b)
        return res.X, res.U

    # Back-to-back warm-started solves chained on device (lax.fori_loop):
    # the deployed configuration — the closed-loop examples run the whole
    # MPC loop inside one jitted scan, so no host dispatch separates
    # consecutive solves.  Each chain step is a full solve (2 SQP iters).
    R = 10

    @jax.jit
    def solve_chain(xs_b, goals_b, X_b, U_b, wrench_b):
        def body(_, XU):
            res = batch_solve(xs_b, goals_b, XU[0], XU[1], wrench_b)
            return res.X, res.U

        return jax.lax.fori_loop(0, R, body, (X_b, U_b))

    # Compile + warm up both programs.
    X_w, U_w = solve(xs_b, goals_b, X_b, U_b, wrench_b)
    jax.block_until_ready((X_w, U_w))
    out = solve_chain(xs_b, goals_b, X_w, U_w, wrench_b)
    jax.block_until_ready(out)

    # Blocking single-dispatch latency: block_until_ready EVERY call (the
    # external-plant real-time tick pays this full host->device->host
    # round trip).  A pipelined version of this loop measures enqueue
    # throughput, not tick latency.
    iters = 50
    t0 = time.perf_counter()
    for _ in range(iters):
        X_w, U_w = solve(xs_b, goals_b, X_w, U_w, wrench_b)
        jax.block_until_ready((X_w, U_w))
    t_dispatch = (time.perf_counter() - t0) / iters

    # Throughput: chained back-to-back solves.
    iters = 20
    t0 = time.perf_counter()
    for _ in range(iters):
        out = solve_chain(xs_b, goals_b, out[0], out[1], wrench_b)
    jax.block_until_ready(out)
    per_solve_s = (time.perf_counter() - t0) / (iters * R)
    return per_solve_s, t_dispatch


def main():
    from indy7_mpc.utils.cache import enable_cache
    from indy7_mpc.utils.device import gpu_line

    device = gpu_line()
    print(f"# {device}", file=sys.stderr)
    enable_cache()
    B = 64
    kind = jax.devices()[0].device_kind

    for N in (32, 64):
        # Three independent repeats, so every result carries its own
        # run-to-run spread.
        reps = [measure(B, N) for _ in range(3)]
        sps_reps = sorted(B / r[0] for r in reps)
        t_dispatch = min(r[1] for r in reps)
        sps = sps_reps[1]  # median of 3
        print(
            f"# B={B} N={N}: {1e6 * B / sps:.0f} us/solve chained on "
            f"device (median of 3 runs: {sps_reps[0]:,.0f}/{sps:,.0f}/"
            f"{sps_reps[2]:,.0f} solves/s), {t_dispatch * 1e6:.0f} us "
            f"blocking single-dispatch  (2 SQP iters, {kind})",
            file=sys.stderr,
        )
        if N == 64:
            # Matched config (reference recorded B=64 at N=64): honest
            # apples-to-apples ratio.
            print(
                json.dumps(
                    {
                        "metric": "sqp_mpc_solves_per_sec_b64_n64",
                        "value": round(sps, 1),
                        "unit": "solves/s",
                        "vs_baseline": round(sps / REF_SOLVES_PER_SEC, 3),
                        "median": round(sps, 1),
                        "min": round(sps_reps[0], 1),
                        "max": round(sps_reps[2], 1),
                        "device": device,
                    }
                )
            )


if __name__ == "__main__":
    main()
