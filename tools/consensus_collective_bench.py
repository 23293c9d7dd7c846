#!/usr/bin/env python
"""Measure the sharded tick's per-tick collective cost in isolation.

The lane-sharded closed loop's ONLY cross-device traffic is the
consensus reduction (argmin over per-lane prediction errors) and the
winner-trajectory gather/broadcast (parallel/sharding.py).  This bench
spawns N gloo CPU processes, shards (err, X, U) at the production shape
over them, and times exactly those ops — compile is seconds (the big
closed-loop program is not involved), so the measurement isolates
fabric cost from everything else (VERDICT r4 weak #3b).

Usage:  python tools/consensus_collective_bench.py [--procs 2] [--B 256]
        [--N 64]
Prints one JSON line: measured us/tick + analytic wire bytes.

Every worker process is pinned to the CPU platform (JAX_PLATFORMS=cpu):
several JAX processes cannot share one GPU (each reserves most of its
memory), so this rig never opens the card.
"""
import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(__file__), "..")


def worker(args):
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=1"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=args.coordinator,
        num_processes=args.procs,
        process_id=args.proc_id,
    )
    import time

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    B, N = args.B, args.N
    mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("lanes",))
    lanes = NamedSharding(mesh, P("lanes"))

    n_dev = len(jax.devices())
    per = B // n_dev
    lo = jax.process_index() * per
    err_l = np.arange(lo, lo + per, dtype=np.float32) + 1.0
    err_sh = jax.make_array_from_process_local_data(lanes, err_l, (B,))
    X_l = np.zeros((per, N, 12), np.float32)
    X_sh = jax.make_array_from_process_local_data(lanes, X_l, (B, N, 12))
    U_l = np.zeros((per, N - 1, 6), np.float32)
    U_sh = jax.make_array_from_process_local_data(
        lanes, U_l, (B, N - 1, 6)
    )

    @jax.jit
    def consensus(err, X, U):
        best = jnp.argmin(err)
        return best, X[best], U[best]

    out = consensus(err_sh, X_sh, U_sh)
    jax.block_until_ready(out)
    reps = 300
    t0 = time.perf_counter()
    for _ in range(reps):
        out = consensus(err_sh, X_sh, U_sh)
        jax.block_until_ready(out)
    us = (time.perf_counter() - t0) / reps * 1e6

    if jax.process_index() == 0:
        winner_bytes = (N * 12 + (N - 1) * 6) * 4 * max(n_dev - 1, 0)
        print(json.dumps({
            "metric": "consensus_collective_cost",
            "procs": args.procs,
            "devices": n_dev,
            "B": B,
            "N": N,
            "us_per_tick": round(us, 1),
            "bytes_per_tick": winner_bytes + 8 * n_dev,
            "protocol": (
                "blocking jit dispatches of {argmin over lane-sharded "
                "err; winner X/U gather} at the production shape, gloo "
                "CPU fabric; includes per-dispatch host overhead"
            ),
        }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default="localhost:8731")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--N", type=int, default=64)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    ps = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--coordinator", args.coordinator,
             "--procs", str(args.procs), "--proc-id", str(i),
             "--B", str(args.B), "--N", str(args.N)],
            stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
            stderr=subprocess.DEVNULL, text=True, env=env, cwd=ROOT,
        )
        for i in range(args.procs)
    ]
    out0, _ = ps[0].communicate(timeout=1800)
    for p in ps[1:]:
        p.wait(timeout=1800)
    print([l for l in out0.splitlines() if l.startswith("{")][-1])


if __name__ == "__main__":
    main()
