#!/usr/bin/env python
"""Multi-process (multi-host) sampled-MPC scale-out bench and demo.

BASELINE.json config 5: "multi-host 32k-scenario MPC sweep ... with
cross-host cost reduction".  One controller process per host; the lane
axis shards over every device of every process and the consensus argmin
runs as a global collective (parallel/distributed.py).

The measured program is the full CLOSED LOOP at the production
configuration (N=64, 2 SQP iterations, fig-8 reference, random-walking
true disturbance): controller tick + device plant + reference advance,
``--chunk`` ticks per dispatch inside one ``lax.scan``
(parallel/sharding.py make_sharded_sampled_loop).  The loop carry —
including the lane-sharded hypothesis batch — stays device-resident
across ticks; nothing per-tick is assembled host-side (VERDICT r3 #1).

Two ways to run:

* Hardware-free rig (virtual CPU devices, gloo).  The launcher pins
  every worker to the CPU platform: several JAX processes cannot share
  one GPU (each reserves most of its memory), so the rig never opens it:
      python examples/multihost_bench.py --procs 2 --devices-per-proc 1 \
          --B 256 --ticks 500 --efficiency
  The launcher spawns one worker copy of itself per process and prints a
  JSON line from worker 0, plus a scaling-efficiency line comparing
  against a single-process run of the same global problem on the same
  total device count.

* Several hosts (one copy per host):
      python examples/multihost_bench.py --worker --coordinator host0:8476 \
          --procs <n_hosts> --proc-id <i> --B 32768 --N 32

The worker path is identical in both cases — that is the point.
"""
import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def worker(args) -> None:
    # Disable the dynamics-layer inner jit for this worker: it trades
    # ~3x faster TRACING for measurably slower XLA:CPU COMPILATION of
    # very large programs; the N=64 lane-sharded loop's compile grew
    # past the gloo pair idle timeout (observed: "Gloo AllGather
    # failed: Application timeout caused pair closure" at the first
    # post-compile collective).  Must be set before indy7 imports.
    os.environ["INDY7_INNER_JIT"] = "0"

    from indy7_mpc.parallel import distributed as dist

    if args.devices_per_proc > 0:
        # CPU rig: enable x64 in the ENTRY POINT (not library init) so
        # the readable Riccati sweep takes its f64 stabilization path at
        # N=64/f32 (ops/riccati.py solve).  The measured solver here is
        # therefore the f64 vmap sweep, NOT the f32 GPU production
        # solver — the scaling numbers quantify the collective/fabric
        # overhead, not solver throughput.
        import jax

        jax.config.update("jax_enable_x64", True)
    dist.initialize(
        args.coordinator,
        args.procs,
        args.proc_id,
        cpu_devices_per_process=(
            args.devices_per_proc if args.devices_per_proc > 0 else None
        ),
    )
    import jax
    import jax.numpy as jnp
    import numpy as np

    from indy7_mpc.utils.cache import enable_cache

    enable_cache()  # persistent compile cache across worker invocations

    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.models import indy7
    from indy7_mpc.mpc import reference
    from indy7_mpc.mpc.sampled import SampledLoopCarry, init_loop_carry
    from indy7_mpc.parallel import make_sharded_sampled_loop

    B, N, dt = args.B, args.N, 0.01
    dtype = jnp.float32
    model = indy7(dtype=dtype)
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=args.sqp_iters)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0,
                              f_ext_resample_std=1.0)
    mpc_cfg = MPCConfig(N=N, dt=dt)

    # The reference's recorded-run protocol (gato_controller.py:306-341).
    ref = reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=dt,
        cycles=max(1, (args.ticks + N) // 1000 + 1),
    )
    ref = np.asarray(reference.with_padding(ref, 200), np.float32)

    mesh = dist.global_lane_mesh()
    chunk = max(1, min(args.chunk, args.ticks))
    loop, _ = make_sharded_sampled_loop(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, mesh,
        jnp.asarray(ref), chunk,
    )

    # Cold-start carry: identical host values in every process (seeded),
    # then placed ONCE as global arrays — f_batch lane-sharded, the rest
    # replicated.  After this, the carry never leaves the devices.
    # The reference sim's fixed initial pose (sim_node.cpp:196).
    x0 = jnp.zeros(12, dtype).at[:6].set(jnp.asarray(
        [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190], dtype
    ))
    c0 = init_loop_carry(
        model, mpc_cfg, sample_cfg, x0,
        jnp.asarray([-60.0, 20.0, -40.0, 0, 0, 0], dtype),
        jax.random.PRNGKey(42),
    )
    rep = lambda v: dist.replicated_global(mesh, np.asarray(v))
    carry = SampledLoopCarry(
        x=rep(c0.x), x_last=rep(c0.x_last), u_last=rep(c0.u_last),
        X_best=rep(c0.X_best), U_best=rep(c0.U_best),
        f_batch=dist.global_lanes(mesh, np.asarray(c0.f_batch)),
        f_true=rep(c0.f_true), key=rep(c0.key), ref_offset=rep(c0.ref_offset),
    )

    t_c0 = time.perf_counter()
    carry, trace = loop(carry)      # compile + first chunk
    jax.block_until_ready(carry)
    compile_s = time.perf_counter() - t_c0

    n_chunks = max(1, args.ticks // chunk)
    t0 = time.perf_counter()
    last_trace = trace
    for _ in range(n_chunks):
        carry, last_trace = loop(carry)
    jax.block_until_ready(carry)
    elapsed = time.perf_counter() - t0
    ticks_measured = n_chunks * chunk

    # ---- per-tick collective accounting (VERDICT r4 weak #3) ----
    # The sharded tick's ONLY cross-device traffic is the consensus
    # reduction (argmin over the lane-sharded prediction errors) and the
    # winner-trajectory gather/broadcast.  Measure exactly those ops at
    # the production shape under the same mesh, isolated from the solve.
    # Multi-process only: under a 1-process gloo runtime the standalone
    # jitted collective dies with "Gloo AllGather failed: Connection
    # closed by peer" (no real pairs exist); the single-process baseline
    # run therefore skips it.  The dedicated harness is
    # tools/consensus_collective_bench.py.
    consensus_us = None
    from jax.sharding import NamedSharding, PartitionSpec as P

    lanes_sh = NamedSharding(mesh, P("lanes"))
    if jax.process_count() > 1:
        per = B // len(jax.devices())
        lo = jax.process_index() * per * (
            len(jax.local_devices())
        )
        err_l = np.arange(
            lo, lo + per * len(jax.local_devices()), dtype=np.float32
        ) + 1.0
        err_sh = jax.make_array_from_process_local_data(
            lanes_sh, err_l, (B,)
        )
        Xb_sh = jax.make_array_from_process_local_data(
            lanes_sh,
            np.zeros((err_l.shape[0], N, 12), np.float32), (B, N, 12),
        )
        Ub_sh = jax.make_array_from_process_local_data(
            lanes_sh,
            np.zeros((err_l.shape[0], N - 1, 6), np.float32),
            (B, N - 1, 6),
        )

        @jax.jit
        def consensus(err, Xb, Ub):
            best = jnp.argmin(err)
            return best, Xb[best], Ub[best]

        out = consensus(err_sh, Xb_sh, Ub_sh)
        jax.block_until_ready(out)
        reps = 200
        t0c = time.perf_counter()
        for _ in range(reps):
            out = consensus(err_sh, Xb_sh, Ub_sh)
        jax.block_until_ready(out)
        consensus_us = (time.perf_counter() - t0c) / reps * 1e6
    # Analytic wire bytes: winner X/U broadcast to every non-owning
    # device + the argmin allreduce of one (value, index) pair per device.
    n_dev = len(jax.devices())
    winner_bytes = (N * 12 + (N - 1) * 6) * 4 * max(n_dev - 1, 0)
    argmin_bytes = 8 * n_dev

    if jax.process_index() == 0:
        per_tick = elapsed / ticks_measured
        te = dist.fetch_replicated(last_trace.tracking_error)
        print(json.dumps({
            "procs": args.procs,
            "devices": len(jax.devices()),
            "B": B,
            "N": N,
            "sqp_iters": args.sqp_iters,
            "ticks": ticks_measured,
            "chunk": chunk,
            "compile_s": round(compile_s, 1),
            "tick_s": round(per_tick, 6),
            "solves_per_sec": round(B / per_tick, 1),
            "tracking_last_chunk_mean_m": round(float(np.mean(te)), 4),
            "best_idx": int(dist.fetch_replicated(last_trace.best_idx)[-1]),
            "u": [round(float(v), 6)
                  for v in dist.fetch_replicated(last_trace.u)[-1]],
            "f_est": [round(float(v), 5)
                      for v in dist.fetch_replicated(last_trace.f_est)[-1]],
            # consensus collective (argmin + winner gather) in isolation,
            # incl. dispatch; analytic wire bytes for the same ops.
            "consensus_us_per_tick": round(consensus_us, 1),
            "consensus_bytes_per_tick": winner_bytes + argmin_bytes,
        }), flush=True)


def launch(args) -> None:
    """Spawn --procs worker copies on this machine (CPU rig) and report."""

    def run(procs, dpp, port):
        cmd_base = [
            sys.executable, os.path.abspath(__file__), "--worker",
            "--coordinator", f"localhost:{port}",
            "--procs", str(procs), "--devices-per-proc", str(dpp),
            "--B", str(args.B), "--N", str(args.N),
            "--ticks", str(args.ticks), "--sqp-iters", str(args.sqp_iters),
            "--chunk", str(args.chunk),
        ]
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        ps = [
            subprocess.Popen(
                cmd_base + ["--proc-id", str(i)],
                stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL,
                stderr=subprocess.DEVNULL, text=True, env=env,
            )
            for i in range(procs)
        ]
        out0, _ = ps[0].communicate(timeout=args.timeout)
        for p in ps[1:]:
            p.wait(timeout=args.timeout)
        for p in ps:
            if p.returncode != 0:
                raise RuntimeError(f"worker rc={p.returncode}")
        line = [l for l in out0.splitlines() if l.startswith("{")][-1]
        return json.loads(line)

    total_dev = args.procs * args.devices_per_proc
    multi = run(args.procs, args.devices_per_proc, args.port)
    print(json.dumps(multi))
    if args.efficiency:
        single = run(1, total_dev, args.port + 1)
        eff = multi["solves_per_sec"] / max(single["solves_per_sec"], 1e-9)
        print(json.dumps({
            "metric": "multiproc_scaling_efficiency",
            "procs": args.procs,
            "devices": total_dev,
            "B": args.B, "N": args.N, "sqp_iters": args.sqp_iters,
            "ticks": args.ticks, "chunk": args.chunk,
            "value": round(eff, 3),
            "single_proc_solves_per_sec": single["solves_per_sec"],
            "multi_proc_solves_per_sec": multi["solves_per_sec"],
            "consensus_match": multi["best_idx"] == single["best_idx"],
        }))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default="localhost:8476")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--devices-per-proc", type=int, default=1)
    # Production configuration (the reference's recorded-run shape with
    # the ensemble widened past one host: BASELINE.md north star).
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=10,
                    help="closed-loop ticks per dispatch (one lax.scan)")
    ap.add_argument("--port", type=int, default=8476)
    ap.add_argument("--timeout", type=float, default=7200.0)
    ap.add_argument("--efficiency", action="store_true",
                    help="also run single-process and report efficiency")
    args = ap.parse_args()
    if args.worker:
        worker(args)
    else:
        launch(args)


if __name__ == "__main__":
    main()
