#!/usr/bin/env python
"""Run the multi-process scaling-efficiency measurement at the production
configuration and write MULTIHOST_EFF.json (not committed).

Protocol (VERDICT r3 item 1): the full sampled-MPC closed loop at N=64,
2 SQP iterations, B lanes, >=500 ticks, measured at 2 AND 4 processes on
the gloo CPU rig, each against a single-process run owning the same
total device count.  The loop carry (including the lane-sharded
hypothesis batch) is device-resident across ticks; there is no per-tick
host-side batch assembly (examples/multihost_bench.py).

Usage: python tools/multihost_eff.py [--B 256] [--ticks 500] [--chunk 10]

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
BENCH = os.path.join(ROOT, "examples", "multihost_bench.py")


def run_bench(procs, B, ticks, chunk, port, efficiency=True):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    cmd = [
        sys.executable, BENCH,
        "--procs", str(procs), "--devices-per-proc", "1",
        "--B", str(B), "--N", "64", "--sqp-iters", "2",
        "--ticks", str(ticks), "--chunk", str(chunk),
        "--port", str(port),
    ]
    if efficiency:
        cmd.append("--efficiency")
    out = subprocess.run(
        cmd, capture_output=True, text=True, timeout=14400, env=env,
        cwd=ROOT,
    )
    if out.returncode != 0:
        raise RuntimeError(out.stderr[-2000:])
    lines = [json.loads(l) for l in out.stdout.splitlines()
             if l.startswith("{")]
    return lines  # [worker record, (efficiency record)]


def run_eff(procs, B, ticks, chunk, port):
    lines = run_bench(procs, B, ticks, chunk, port, efficiency=True)
    eff = lines[-1]
    # Surface the worker's collective accounting in the efficiency row.
    for k in ("consensus_us_per_tick", "consensus_bytes_per_tick"):
        if k in lines[0]:
            eff[k] = lines[0][k]
    return eff


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--procs", default="2,4")
    ap.add_argument("--lanes-per-proc", type=int, default=128,
                    help="weak-scaling rows: fixed lanes per process")
    ap.add_argument("--out", default=os.path.join(ROOT, "MULTIHOST_EFF.json"))
    args = ap.parse_args()

    results = []
    for i, procs in enumerate(int(p) for p in args.procs.split(",")):
        rec = run_eff(procs, args.B, args.ticks, args.chunk,
                      port=8510 + 10 * i)
        print(json.dumps(rec), flush=True)
        results.append(rec)

    # Weak scaling: FIXED lanes per process (B = lanes_per_proc * procs).
    # Ideal = constant solves/s/process; this removes the strong-scaling
    # baseline's shared-thread-pool denominator entirely (VERDICT r4
    # weak #3a).
    weak = []
    for i, procs in enumerate([1] + [int(p) for p in args.procs.split(",")]):
        rec = run_bench(
            procs, args.lanes_per_proc * procs, args.ticks, args.chunk,
            port=8560 + 10 * i, efficiency=False,
        )[0]
        row = {
            "metric": "weak_scaling",
            "procs": procs,
            "B": args.lanes_per_proc * procs,
            "lanes_per_proc": args.lanes_per_proc,
            "solves_per_sec_per_proc": round(
                rec["solves_per_sec"] / procs, 1
            ),
            "solves_per_sec": rec["solves_per_sec"],
        }
        for k in ("consensus_us_per_tick", "consensus_bytes_per_tick"):
            if k in rec:
                row[k] = rec[k]
        print(json.dumps(row), flush=True)
        weak.append(row)

    doc = {
        "protocol": (
            "full sampled-MPC closed loop (solve+consensus+resample+plant"
            "+reference advance), lane axis sharded over jax.distributed "
            "gloo CPU rig, carry device-resident across ticks, chunked "
            "lax.scan dispatch; efficiency = multi-process solves/s over "
            "a single process owning the same total devices"
        ),
        "config": {"B": args.B, "N": 64, "sqp_iters": 2,
                   "ticks": args.ticks, "chunk": args.chunk},
        "results": results,
        "weak_scaling": weak,
        "notes": {
            "why_efficiency_exceeds_1": (
                "the single-process baseline owns the same total virtual "
                "devices inside ONE XLA runtime on a 2-core host, so it "
                "is intra-op thread-pool-bound; separate processes get "
                "genuinely parallel runtimes.  The weak_scaling rows "
                "(fixed lanes/process, solves/s/process vs the 1-process "
                "row) carry no such denominator; the per-tick collective "
                "cost is measured in isolation as consensus_us_per_tick "
                "(argmin allreduce + winner trajectory broadcast, "
                "consensus_bytes_per_tick on the wire)."
            ),
            "measured_solver": (
                "this CPU rig runs the readable vmap solver with its f64 "
                "Riccati stabilization (x64 enabled in the worker entry "
                "point), NOT the f32 GPU production solver; the numbers "
                "quantify fabric/collective overhead at production "
                "shape, not kernel throughput"
            ),
        },
        "target": ">=0.8 (BASELINE.md north star)",
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
