#!/usr/bin/env python
"""On-card smoke test of the sampled-MPC main path.

    python chip_smoke.py           # one GPU, phases 1-4
    python chip_smoke.py --four    # four GPUs, phase 5 only

Phases, in one process; any failure ends the run with a non-zero exit:

  1. device   — the default JAX device must be a GPU (no CPU fallback);
                prints ``nvidia-smi`` name and power limit.
  2. solve    — the production solver (solvers/select.py) at the
                reference deployment B=64, N=64, 2 SQP iterations, then
                B=4096 at N=32 (large-B memory); sampled lanes are
                replayed through the float64 CPU oracle (solvers/replay.py).
  3. loop     — the device-resident closed loop (run_sampled_mpc): fig-8,
                B=64, N=64, perturbed plant, 500 ticks; mean tracking
                error over ticks 200-500 must beat the reference's 0.125 m.
  4. host     — the host-driven loop (SampledController + InProcessPlant),
                B=16, N=64, 50 ticks at 100 Hz; it must close the initial
                tracking error; prints p50/p99 tick latency.
  5. four     — (--four) the lane-sharded closed loop on a 4-GPU mesh
                against the same loop on one GPU, B=256, N=64.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax
import jax.numpy as jnp
import numpy as np

from indy7_mpc.config import (
    CostConfig, MPCConfig, PERTURBED_PLANT, SampleConfig, SQPConfig,
)
from indy7_mpc.models import indy7
from indy7_mpc.mpc import reference
from indy7_mpc.solvers import select
from indy7_mpc.solvers.replay import lane_error, replay_lane

DT = 0.01
# Oracle tolerance (phase 2): max |error| of a lane's X and U after the
# replayed iterations, each scaled by its own magnitude (at least 1).
# The solve runs in float32 and the oracle in float64.
ORACLE_TOL = 2e-3
# Reference tracking error mean at B=64 (BASELINE.md).
REF_TRACKING_M = 0.125
# The fig-8 reference trajectory and start pose of the reference's runs
# (gato_controller.py:306-341, sim_node.cpp:196).
X0_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]


def phase(name):
    print(f"== {name}", flush=True)


def device_phase():
    phase("1 device")
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (default device: {d.platform})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"jax: platform={d.platform} kind={d.device_kind} "
          f"count={len(devs)}", flush=True)
    return d, smi[0]


def problem(B, N, seed):
    """Random warm-started lanes with wrench hypotheses (float32)."""
    rng = np.random.default_rng(seed)
    f = lambda a: jnp.asarray(a, jnp.float32)
    xs = f(rng.normal(size=(B, 12)) * 0.05)
    goals = f(rng.normal(size=(B, N, 3)) * 0.3)
    X = f(rng.normal(size=(B, N, 12)) * 0.05)
    U = f(rng.normal(size=(B, N - 1, 6)) * 0.5)
    w = f(rng.normal(size=(B, 6)) * 8).at[:, 3:].set(0.0)
    return xs, goals, X, U, w


def solve_phase(model, cost, scfg):
    phase("2 solve (production solver vs float64 oracle)")
    assert select.use_lane(cost, scfg), "GPU did not select the lane solver"
    solve = jax.jit(select.default_batch_solve_fn(model, cost, scfg, DT))
    for B, N in ((64, 64), (4096, 32)):
        a = problem(B, N, seed=B + N)
        t0 = time.perf_counter()
        res = jax.block_until_ready(solve(*a))
        t_first = time.perf_counter() - t0
        assert np.all(np.isfinite(np.asarray(res.X))), (B, N)
        assert np.all(np.isfinite(np.asarray(res.U))), (B, N)
        errs = []
        for lane in sorted({0, B // 3, (2 * B) // 3, B - 1}):
            X_e, U_e, rho_e = replay_lane(
                model, cost, scfg, DT, a[0][lane], a[1][lane], a[2][lane],
                a[3][lane], a[4][lane], np.asarray(res.stats.alphas[lane]),
                scfg.rho,
            )
            errs.append(lane_error(res.X[lane], res.U[lane], X_e, U_e))
            assert abs(float(res.state.rho[lane]) - rho_e) <= 1e-5 * rho_e
        err = max(errs)
        print(f"B={B} N={N}: first call {t_first:.1f} s, oracle error "
              f"{err:.3e} (tol {ORACLE_TOL:g}, float32 vs float64)",
              flush=True)
        assert err < ORACLE_TOL, (B, N, err)


def fig8_ref(ticks, N):
    ref = reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT,
        cycles=10,
    )
    return jnp.asarray(reference.with_padding(ref, 200)[: ticks + N + 1],
                       jnp.float32)


def x0():
    return jnp.zeros(12, jnp.float32).at[:6].set(
        jnp.asarray(X0_Q, jnp.float32)
    )


def loop_phase(model, cost, scfg):
    phase("3 loop (device closed loop, fig-8, perturbed plant)")
    from indy7_mpc.mpc import run_sampled_mpc

    B, N, ticks = 64, 64, 500
    mpc_cfg = MPCConfig(N=N, dt=DT)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0,
                              f_ext_resample_std=1.0)
    run = jax.jit(lambda x0, key: run_sampled_mpc(
        model, cost, scfg, mpc_cfg, sample_cfg, x0, fig8_ref(ticks, N),
        ticks, jnp.asarray(F_TRUE, jnp.float32), key,
        plant_cfg=PERTURBED_PLANT,
    ))
    key = jax.random.PRNGKey(42)
    t0 = time.perf_counter()
    _, tr = jax.block_until_ready(run(x0(), key))
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, tr = jax.block_until_ready(run(x0(), key))
    per_tick = (time.perf_counter() - t0) / ticks
    te = np.asarray(tr.tracking_error)
    for f in (te, np.asarray(tr.q), np.asarray(tr.u), np.asarray(tr.f_est)):
        assert np.all(np.isfinite(f))
    f_err = np.linalg.norm(
        np.asarray(tr.f_est)[200:, :3] - np.asarray(tr.f_true)[200:, :3],
        axis=1,
    )
    print(f"wrench estimate error, ticks 200-500: mean {f_err.mean():.2f} N, "
          f"p50 {np.percentile(f_err, 50):.2f} N", flush=True)
    print(f"B={B} N={N}: {per_tick * 1e6:.0f} us/tick on device (first "
          f"call {t_first:.1f} s); tracking error mean ticks 200-500 "
          f"{te[200:].mean():.4f} m (reference {REF_TRACKING_M} m)",
          flush=True)
    assert te[200:].mean() < REF_TRACKING_M


def host_phase(model, cost, scfg, card):
    phase("4 host (SampledController + InProcessPlant)")
    from indy7_mpc.runtime.controller import SampledController, run_control_loop
    from indy7_mpc.runtime.stats import RunRecorder
    from indy7_mpc.runtime.transport import InProcessPlant

    B, N, ticks = 16, 64, 50
    mpc_cfg = MPCConfig(N=N, dt=DT)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0,
                              f_ext_resample_std=1.0)
    ctrl = SampledController(
        model, cost, scfg, mpc_cfg, sample_cfg, np.asarray(fig8_ref(600, N)),
        f_ext_actual=F_TRUE[:3],
    )
    plant = InProcessPlant(model, x0(), DT, plant_cfg=PERTURBED_PLANT)
    rec = RunRecorder(
        out_dir=os.path.join(ROOT, "chiprun_out", "smoke_stats"),
        save_interval=float("inf"),
    )
    run_control_loop(ctrl, plant, duration=60.0, recorder=rec,
                     max_ticks=ticks)
    te = np.asarray(rec._data["tracking_errors"])
    lat = np.asarray(rec._data["solve_times"])
    assert te.size == ticks and np.all(np.isfinite(te))
    print(f"host tick latency B={B} N={N} on {card}: "
          f"p50 {np.percentile(lat, 50):.0f} us, "
          f"p99 {np.percentile(lat, 99):.0f} us; tracking error first "
          f"{te[0]:.4f} m, last 10 mean {te[-10:].mean():.4f} m", flush=True)
    assert te[-10:].mean() < te[0]


def four_phase(model, cost, scfg):
    phase("5 four (lane-sharded closed loop, 4 GPUs vs 1)")
    from indy7_mpc.mpc.sampled import init_loop_carry
    from indy7_mpc.parallel import make_lane_mesh, make_sharded_sampled_loop

    devs = jax.devices()
    assert len(devs) >= 4, f"--four needs 4 GPUs, found {len(devs)}"
    B, N, ticks = 256, 64, 50
    mpc_cfg = MPCConfig(N=N, dt=DT)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0,
                              f_ext_resample_std=1.0)
    traces = []
    for mesh_devs in (devs[:4], devs[:1]):
        mesh = make_lane_mesh(mesh_devs)
        loop, shardings = make_sharded_sampled_loop(
            model, cost, scfg, mpc_cfg, sample_cfg, mesh,
            fig8_ref(ticks, N), chunk=ticks, plant_cfg=PERTURBED_PLANT,
        )
        c0 = jax.device_put(
            init_loop_carry(model, mpc_cfg, sample_cfg, x0(),
                            jnp.asarray(F_TRUE, jnp.float32),
                            jax.random.PRNGKey(7)),
            shardings,
        )
        t0 = time.perf_counter()
        _, tr = jax.block_until_ready(loop(c0))
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, tr = jax.block_until_ready(loop(c0))
        per_tick = (time.perf_counter() - t0) / ticks
        print(f"{len(mesh_devs)} GPU(s): {per_tick * 1e6:.0f} us/tick "
              f"(first call {t_first:.1f} s)", flush=True)
        traces.append(jax.device_get(tr))
    t4, t1 = traces
    same = np.asarray(t4.best_idx) == np.asarray(t1.best_idx)
    dq = float(np.abs(np.asarray(t4.q) - np.asarray(t1.q)).max())
    print(f"best_idx equal on {int(same.sum())}/{ticks} ticks; "
          f"max |q_4 - q_1| {dq:.3e} rad", flush=True)
    assert same.all() and dq < 1e-4
    assert np.all(np.isfinite(np.asarray(t4.tracking_error)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-GPU lane-sharded loop")
    args = ap.parse_args()

    d, card = device_phase()
    from indy7_mpc.utils.cache import enable_cache

    enable_cache()
    model = indy7(dtype=jnp.float32)
    cost, scfg = CostConfig(), SQPConfig(max_iters=2)
    if args.four:
        four_phase(model, cost, scfg)
    else:
        solve_phase(model, cost, scfg)
        loop_phase(model, cost, scfg)
        host_phase(model, cost, scfg, card)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
