"""Float64 CPU oracle for checking a batched solver lane by lane.

The line search makes discrete choices, so a float32 solve and a float64
reference can legitimately accept different step lengths on the same
lane.  The oracle therefore *replays* the solver's own accepted-alpha log
through the readable dense path (ops/kkt.build_qp_gn + ops/riccati.solve)
in float64 on the host CPU, applying the masked update / Levenberg rho /
step-norm-exit semantics of ``solvers/sqp_lane.accept_step``.  What is
left to compare is the continuous part of each step.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel


def replay_lane(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs,
    goals,
    X0,
    U0,
    wrench,
    alphas,
    rho0: float,
):
    """(X, U, rho) of one lane after replaying ``alphas`` (max_iters,)."""
    from ..ops import kkt, riccati

    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        m = jax.device_put(model, cpu).astype(jnp.float64)
        f64 = lambda a: None if a is None else jnp.asarray(np.asarray(a), jnp.float64)
        goals, wrench = f64(goals), f64(wrench)
        X = np.array(X0, np.float64)
        X[0] = np.asarray(xs)
        U = np.array(U0, np.float64)
        rho, done = float(rho0), False
        for alpha in np.asarray(alphas, np.float64):
            if done:
                continue
            blocks = kkt.build_qp_gn(
                m, cost_cfg, jnp.asarray(X), jnp.asarray(U), goals, dt,
                wrench_world=wrench,
            )
            sol = riccati.solve(blocks, jnp.zeros(12, jnp.float64), rho)
            dX, dU = np.asarray(sol.X), np.asarray(sol.U)
            if alpha > 0.0:
                X = X + alpha * dX
                U = U + alpha * dU
                step = alpha * np.sqrt((dX**2).sum() + (dU**2).sum())
                done = bool(step < sqp_cfg.step_tol)
            else:
                rho = float(
                    np.clip(rho * sqp_cfg.rho_factor, sqp_cfg.rho, sqp_cfg.rho_max)
                )
    return X, U, rho


def lane_error(X, U, X_exp, U_exp) -> float:
    """Max abs error of (X, U) against the oracle, each scaled by its own
    magnitude (at least 1) — the measure the tolerances are stated in."""
    X, U = np.asarray(X, np.float64), np.asarray(U, np.float64)
    x_scale = max(1.0, float(np.abs(X_exp).max()))
    u_scale = max(1.0, float(np.abs(U_exp).max()))
    return max(
        float(np.abs(X - X_exp).max()) / x_scale,
        float(np.abs(U - U_exp).max()) / u_scale,
    )
