"""Sampled-MPC: batched wrench-hypothesis estimation + consensus control.

This is the reference's scientific core re-built in JAX: B lanes each
solve the same tracking problem under a *different* hypothesized external
wrench; a consensus step picks the lane whose one-step prediction best
matches the observed state, and hypotheses are resampled around the winner
(/root/reference/gato_controller.py:48-141, 201-256;
src/gato_mpc_batch_sample.py:106-300).

Everything — B SQP solves, the plant, scoring, resampling — is one jitted
``lax.scan``; the lane axis is a vmap axis that shards over a device mesh
(parallel/sharding.py), replacing the CUDA template classes and the
CPU-side argmin (gato_controller.py:109-118) with an on-device argmin.

Exact semantic mirrors:
  * hypothesis init: N(0, f_ext_std) forces, zero torques, lane 0 pinned
    to zero (gato_controller.py:77-83);
  * scoring: argmin_i ||sim_forward(x_last, u_last, dt; w_i) - x_obs||
    (gato_controller.py:109-118);
  * resample: copy winner, add N(0, resample_std), restore winner row,
    zero torques, re-pin lane 0, decay by 0.97 (gato_controller.py:120-129);
  * warm start: every lane restarts from the winning trajectory with the
    measured state pinned — no receding shift (gato_controller.py:217-218,
    249);
  * true-disturbance random walk every 200 reference steps, clipped to
    +/-20 N (gato_controller.py:236-239).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig
from ..dynamics.kinematics import ee_pos
from ..models.robot import RobotModel
from ..sim.plant import make_plant_step, plant_step, predict_next_states


def init_wrench_batch(key, cfg: SampleConfig, dtype=jnp.float32):
    """Initial hypothesis batch (gato_controller.py:77-83)."""
    f = cfg.f_ext_std * jax.random.normal(key, (cfg.batch_size, 6), dtype)
    f = f.at[:, 3:].set(0.0)
    f = f.at[0].set(0.0)
    return f


def resample_wrench_batch(key, f_batch, best_idx, cfg: SampleConfig):
    """Resample hypotheses around the winner (gato_controller.py:120-129)."""
    f_best = f_batch[best_idx]
    f = f_best[None, :] + cfg.f_ext_resample_std * jax.random.normal(
        key, f_batch.shape, f_batch.dtype
    )
    f = f.at[best_idx].set(f_best)
    f = f.at[:, 3:].set(0.0)
    f = f.at[0].set(0.0)
    return f * cfg.decay


def find_best_lane(model, x_last, u_last, x_obs, dt, f_batch):
    """Consensus scoring (gato_controller.py:109-118), fully on device."""
    x_pred = predict_next_states(model, x_last, u_last, dt, f_batch)
    err = jnp.linalg.norm(x_pred - x_obs[None, :], axis=-1)
    return jnp.argmin(err), err


class SampledTickResult(NamedTuple):
    u: jnp.ndarray            # (nu,) consensus control to apply
    best_idx: jnp.ndarray     # () winning lane
    X_best: jnp.ndarray       # (N, nx)
    U_best: jnp.ndarray       # (N-1, nu)
    f_batch: jnp.ndarray      # (B, 6) resampled hypotheses
    f_est: jnp.ndarray        # (6,) winning wrench estimate
    sqp_iters: jnp.ndarray


def sampled_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    sample_cfg: SampleConfig,
    dt: float,
    key,
    x_obs,
    x_last,
    u_last,
    goals,
    X_warm,
    U_warm,
    f_batch,
    batch_solve_fn=None,
) -> SampledTickResult:
    """One control tick: batch-solve, score, resample, pick control.

    This mirrors ``GATO_Controller.joint_callback`` (gato_controller.py:
    201-256) minus transport; usable from both the pure-JAX closed loop
    and the external-plant runtime.  ``batch_solve_fn`` lets the sharded
    path inject a pjit-ed solver; by default the production solver for
    the current device is used (the lane-major solver on a GPU, the
    readable vmap solver on CPU — solvers/select.py).
    """
    from ..solvers.select import default_batch_solve_fn

    # Pin f32 matmul precision: on a GPU the default lets the small
    # consensus/FK float32 products run in TF32 (~3 decimal digits), far
    # too coarse to rank one-step predictions (see sim/plant.py
    # plant_step).  No-op on CPU.
    with jax.default_matmul_precision("highest"):
        return _sampled_tick_impl(
            model, cost_cfg, sqp_cfg, sample_cfg, dt, key, x_obs, x_last,
            u_last, goals, X_warm, U_warm, f_batch, batch_solve_fn,
            default_batch_solve_fn,
        )


def _sampled_tick_impl(
    model, cost_cfg, sqp_cfg, sample_cfg, dt, key, x_obs, x_last, u_last,
    goals, X_warm, U_warm, f_batch, batch_solve_fn, default_batch_solve_fn,
):
    B = f_batch.shape[0]
    xs_b = jnp.tile(x_obs, (B, 1))
    X_b = jnp.tile(X_warm.at[0].set(x_obs), (B, 1, 1))
    U_b = jnp.tile(U_warm, (B, 1, 1))
    goals_b = jnp.tile(goals, (B, 1, 1))

    solve = batch_solve_fn or default_batch_solve_fn(
        model, cost_cfg, sqp_cfg, dt
    )
    res = solve(xs_b, goals_b, X_b, U_b, f_batch)

    best, _ = find_best_lane(model, x_last, u_last, x_obs, dt, f_batch)
    key_r, _ = jax.random.split(key)
    f_new = resample_wrench_batch(key_r, f_batch, best, sample_cfg)

    X_best = res.X[best]
    U_best = res.U[best]
    return SampledTickResult(
        u=U_best[0],
        best_idx=best,
        X_best=X_best,
        U_best=U_best,
        f_batch=f_new,
        f_est=f_batch[best],
        sqp_iters=res.stats.iterations[best],
    )


class SampledLoopCarry(NamedTuple):
    x: jnp.ndarray
    x_last: jnp.ndarray
    u_last: jnp.ndarray
    X_best: jnp.ndarray
    U_best: jnp.ndarray
    f_batch: jnp.ndarray
    f_true: jnp.ndarray
    key: jax.Array
    ref_offset: jnp.ndarray


class SampledTrace(NamedTuple):
    tracking_error: jnp.ndarray  # (T,)
    ee_pos: jnp.ndarray          # (T, 3)
    ee_ref: jnp.ndarray          # (T, 3)
    q: jnp.ndarray               # (T, nq)
    u: jnp.ndarray               # (T, nu)
    best_idx: jnp.ndarray        # (T,)
    f_est: jnp.ndarray           # (T, 6)
    f_true: jnp.ndarray          # (T, 6)
    x: jnp.ndarray = None        # (T, nx) full plant state (live telemetry)


def make_loop_tick(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    ref_traj,
    f_true_walk: bool = True,
    batch_solve_fn=None,
    plant_cfg: Optional[PlantConfig] = None,
    plant_model: Optional[RobotModel] = None,
):
    """``tick(carry, _) -> (carry, SampledTrace)`` — one closed-loop step
    (controller tick + ground-truth plant step + reference advance).

    The single tick body shared by :func:`run_sampled_mpc` (single-device
    ``lax.scan``) and the lane-sharded multi-host loop
    (parallel/sharding.py make_sharded_sampled_loop), so the distributed
    path scans the *identical* program.
    """
    N, dt = mpc_cfg.N, mpc_cfg.dt
    pm = model if plant_model is None else plant_model
    ref_traj = jnp.asarray(ref_traj)
    if plant_cfg is None:
        plant_fn = lambda x, u, w, k: plant_step(
            pm, x, u, dt, wrench_world=w, substeps=mpc_cfg.sim_substeps
        )
    else:
        _, _step = make_plant_step(pm, plant_cfg)
        plant_fn = lambda x, u, w, k: _step(x, u, w, k, dt)

    def tick(carry: SampledLoopCarry, _):
        with jax.default_matmul_precision("highest"):
            return _tick(carry)

    def _tick(carry: SampledLoopCarry):
        key, k_tick, k_walk, k_plant = jax.random.split(carry.key, 4)
        goals = jax.lax.dynamic_slice_in_dim(ref_traj, carry.ref_offset, N, 0)

        out = sampled_tick(
            model, cost_cfg, sqp_cfg, sample_cfg, dt,
            k_tick, carry.x, carry.x_last, carry.u_last, goals,
            carry.X_best, carry.U_best, carry.f_batch,
            batch_solve_fn=batch_solve_fn,
        )

        # True-plant step under the true wrench.
        x_next = plant_fn(carry.x, out.u, carry.f_true, k_plant)

        # Random-walk the true disturbance (gato_controller.py:236-239).
        walked = carry.f_true.at[:3].set(
            jnp.clip(
                carry.f_true[:3]
                + jax.random.normal(k_walk, (3,), carry.x.dtype),
                -20.0, 20.0,
            )
        )
        do_walk = jnp.logical_and(
            jnp.asarray(f_true_walk), carry.ref_offset % 200 == 0
        )
        f_true = jnp.where(do_walk, walked, carry.f_true)

        eep = ee_pos(model, carry.x[: model.nq])
        trace = SampledTrace(
            tracking_error=jnp.linalg.norm(eep - goals[0]),
            ee_pos=eep,
            ee_ref=goals[0],
            q=carry.x[: model.nq],
            u=out.u,
            best_idx=out.best_idx,
            f_est=out.f_est,
            f_true=carry.f_true,
            x=carry.x,
        )
        new_carry = SampledLoopCarry(
            x=x_next,
            x_last=carry.x,
            u_last=out.u,
            X_best=out.X_best,
            U_best=out.U_best,
            f_batch=out.f_batch,
            f_true=f_true,
            key=key,
            ref_offset=carry.ref_offset + 1,
        )
        return new_carry, trace

    return tick


def init_loop_carry(
    model: RobotModel,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    x0,
    f_true0,
    key,
) -> SampledLoopCarry:
    """Initial closed-loop carry (cold start: zero trajectories, fresh
    hypothesis batch — gato_controller.py:77-83, 180-184)."""
    N = mpc_cfg.N
    key, k_init = jax.random.split(key)
    return SampledLoopCarry(
        x=x0,
        x_last=x0,
        u_last=jnp.zeros(model.nu, x0.dtype),
        X_best=jnp.zeros((N, model.nx), x0.dtype).at[0].set(x0),
        U_best=jnp.zeros((N - 1, model.nu), x0.dtype),
        f_batch=init_wrench_batch(k_init, sample_cfg, x0.dtype),
        f_true=jnp.asarray(f_true0, x0.dtype),
        key=key,
        ref_offset=jnp.asarray(0, jnp.int32),
    )


def run_sampled_mpc(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    sample_cfg: SampleConfig,
    x0,
    ref_traj,
    num_steps: int,
    f_true0,
    key,
    f_true_walk: bool = True,
    batch_solve_fn=None,
    plant_cfg: Optional[PlantConfig] = None,
    plant_model: Optional[RobotModel] = None,
):
    """Pure-JAX closed loop: sampled controller vs. device plant.

    Args:
      ref_traj: (T_ref, 3) EE reference positions, T_ref >= num_steps + N.
      f_true0: (6,) true disturbance wrench applied to the plant.
      f_true_walk: random-walk the true wrench every 200 steps
        (gato_controller.py:236-239).
      plant_cfg: ground-truth plant perturbations (inertial error,
        friction, actuation noise, finer substeps) so the loop validates
        under model mismatch like the reference's MuJoCo plant does
        (config.PERTURBED_PLANT is the standard setting).  None = the
        controller's own model, single RK4 per tick.
      plant_model: optional DISTINCT robot model for the ground-truth
        plant (e.g. ``models.indy7_mjcf()`` — the vendored MJCF
        description, mirroring the reference's URDF-controller vs
        MJCF-MuJoCo split).  None = the controller's model.

    Returns (final_carry, SampledTrace).
    """
    tick = make_loop_tick(
        model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg,
        jnp.asarray(ref_traj, x0.dtype),
        f_true_walk=f_true_walk,
        batch_solve_fn=batch_solve_fn,
        plant_cfg=plant_cfg,
        plant_model=plant_model,
    )
    carry0 = init_loop_carry(model, mpc_cfg, sample_cfg, x0, f_true0, key)
    return jax.lax.scan(tick, carry0, None, length=num_steps)
