"""Point-to-goal receding-horizon MPC as one jitted lax.scan.

Re-design of the reference's offline MPC loops
(/root/reference/src/osqp_mpc.py:14-71, src/gato_mpc.py:53-150): the whole
closed loop — SQP solve, plant step, receding-horizon shift, goal chain
advance, divergence freeze — is a single ``lax.scan`` program resident on
device.  No Python in the loop, no transport.

Semantics parity:
  * goal switch when EE-goal distance < goal_switch_dist, cycling through
    the endpoint list (osqp_mpc.py:34-38);
  * divergence freeze (instead of ``break``) when distance >
    divergence_dist (osqp_mpc.py:41-43) — the carry stops updating;
  * warm start by one-knot receding shift with the terminal state
    duplicated.  (Deliberate deviation: the reference fills the shifted
    terminal state with ``[1, ..., 1, 0, ..., 0]`` (osqp_mpc.py:70), which
    measurably poisons warm starts at low SQP iteration counts.)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import CostConfig, MPCConfig, SQPConfig
from ..dynamics.kinematics import ee_pos
from ..models.robot import RobotModel
from ..sim.plant import plant_step
from ..solvers import sqp as sqp_mod


class MPCCarry(NamedTuple):
    x: jnp.ndarray          # (nx,) plant state
    X: jnp.ndarray          # (N, nx) warm-start states
    U: jnp.ndarray          # (N-1, nu) warm-start controls
    goal_idx: jnp.ndarray   # () int32
    alive: jnp.ndarray      # () bool — False after divergence
    state: sqp_mod.SolverState


class MPCTrace(NamedTuple):
    x: jnp.ndarray          # (T, nx) plant states after each tick
    u: jnp.ndarray          # (T, nu) applied torque
    goal_dist: jnp.ndarray  # (T,)
    goal_idx: jnp.ndarray   # (T,)
    sqp_iters: jnp.ndarray  # (T,)


def run_mpc(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    mpc_cfg: MPCConfig,
    x0,
    endpoints,
    num_steps: int,
    wrench_world: Optional[jnp.ndarray] = None,
    solve_fn=None,
):
    """Closed-loop point-to-goal MPC.

    Args:
      x0: (nx,) initial plant state.
      endpoints: (G, 3) chain of EE goals, cycled on arrival.
      num_steps: control ticks (static).
      wrench_world: optional true disturbance wrench on the plant.
      solve_fn: optional ``(xs, goals, X, U, state) -> SQPResult``
        single-lane solver override; by default the production solver is
        auto-selected for the device (solvers/select.py).

    Returns (final_carry, MPCTrace).
    """
    from ..solvers.select import default_single_solve_fn

    N, dt = mpc_cfg.N, mpc_cfg.dt
    nq, nx, nu = model.nq, model.nx, model.nu
    endpoints = jnp.asarray(endpoints)
    if solve_fn is None:
        solve_fn = default_single_solve_fn(model, cost_cfg, sqp_cfg, dt)

    def tick(carry: MPCCarry, _):
        goal = endpoints[carry.goal_idx]
        cur_ee = ee_pos(model, carry.x[:nq])
        dist = jnp.linalg.norm(cur_ee - goal)

        switch = dist < mpc_cfg.goal_switch_dist
        goal_idx = jnp.where(
            switch,
            (carry.goal_idx + 1) % endpoints.shape[0],
            carry.goal_idx,
        )
        goal = endpoints[goal_idx]
        goals = jnp.tile(goal, (N, 1))

        alive = jnp.logical_and(carry.alive, dist <= mpc_cfg.divergence_dist)

        res = solve_fn(carry.x, goals, carry.X, carry.U, carry.state)
        u = res.U[0]
        x_next = plant_step(
            model, carry.x, u, dt,
            wrench_world=wrench_world, substeps=mpc_cfg.sim_substeps,
        )

        # Receding-horizon shift (osqp_mpc.py:65-69, sane terminal fill).
        X_shift = jnp.concatenate([res.X[1:], res.X[-1:]], axis=0)
        X_shift = X_shift.at[0].set(x_next)
        U_shift = jnp.concatenate([res.U[1:], res.U[-1:]], axis=0)

        keep = alive

        def sel(new, old):
            return jnp.where(keep, new, old)

        new_carry = MPCCarry(
            x=sel(x_next, carry.x),
            X=sel(X_shift, carry.X),
            U=sel(U_shift, carry.U),
            goal_idx=jnp.where(keep, goal_idx, carry.goal_idx),
            alive=alive,
            state=jax.tree.map(sel, res.state, carry.state),
        )
        out = (
            new_carry.x, jnp.where(keep, u, jnp.zeros_like(u)), dist,
            goal_idx, res.stats.iterations,
        )
        return new_carry, out

    carry0 = MPCCarry(
        x=x0,
        X=jnp.zeros((N, nx), x0.dtype).at[0].set(x0),
        U=jnp.zeros((N - 1, nu), x0.dtype),
        goal_idx=jnp.asarray(0, jnp.int32),
        alive=jnp.asarray(True),
        state=sqp_mod.SolverState.init(sqp_cfg),
    )
    # Warm-up solve from zeros (osqp_mpc.py:26-27).
    goals0 = jnp.tile(endpoints[0], (N, 1))
    warm = solve_fn(x0, goals0, carry0.X, carry0.U, carry0.state)
    carry0 = carry0._replace(X=warm.X, U=warm.U, state=warm.state)

    final, (xs, us, dists, gidx, iters) = jax.lax.scan(
        tick, carry0, None, length=num_steps
    )
    return final, MPCTrace(
        x=xs, u=us, goal_dist=dists, goal_idx=gidx, sqp_iters=iters
    )
