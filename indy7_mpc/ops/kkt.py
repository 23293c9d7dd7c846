"""Per-knot dynamics linearization and Gauss-Newton cost blocks.

Batched re-design of the reference's sparse-CSC KKT assembly
(/root/reference/src/osqp_solver.py:31-135): instead of scipy CSC data
rewrites feeding OSQP, we produce structured dense per-knot blocks
``(A_k, B_k, c_k, Q_k, q_k, R_k, r_k)`` that flow straight into the batched
Riccati sweep (ops/riccati.py).  Everything is vmap-able over a lane axis
and scan-friendly over the horizon.

Semantics parity notes (against osqp_solver.py / osqp_sqp.py):
  * Linearization uses the explicit-Euler step (osqp_solver.py:70-81):
      A_k = [[I, dt I], [dt da/dq, I + dt da/dv]],  B_k = [[0], [dt da/du]],
      c_k = f(x_k, u_k) - A_k x_k - B_k u_k.
    We get A, B by ``jacfwd`` of the same Euler step, so external-wrench
    dependence is included exactly (the CPU reference omits wrenches; the
    CUDA solver includes them).
  * Cost blocks (osqp_solver.py:103-135): position Hessian is the outer
    product of ``J^T ee_err`` (the reference's Gauss-Newton-of-the-gradient
    form), velocity/control weights dQ, R adaptively scaled by
    ``1/(|ee_err| + eps)``, terminal position weight QN; gradients
    ``q_k = [Qmod J^T ee_err; dQmod v_k]``, ``r_k = Rmod u_k`` (the QP is
    posed in absolute variables, exactly like the OSQP formulation).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import CostConfig
from ..dynamics.integrators import euler_step
from ..dynamics.kinematics import ee_pos_jacobian
from ..models.robot import RobotModel


class QPBlocks(NamedTuple):
    """Structured block-tridiagonal QP data for one lane.

    Shapes (single lane): A (N-1, nx, nx), B (N-1, nx, nu), c (N-1, nx),
    Q (N, nx, nx), q (N, nx), R (N-1, nu, nu), r (N-1, nu).
    """

    A: jnp.ndarray
    B: jnp.ndarray
    c: jnp.ndarray
    Q: jnp.ndarray
    q: jnp.ndarray
    R: jnp.ndarray
    r: jnp.ndarray


def make_step_fn(model: RobotModel, dt: float, wrench_world=None):
    """Euler step closure, optionally under a world-frame EE wrench.

    ``wrench_world``: (6,) spatial force in world coordinates (moment about
    the world origin, the reference's convention).  It is re-mapped to the
    EE joint frame at every evaluated configuration, which is what the CUDA
    solver's per-lane ``set_external_wrench_batch`` does inside its rollouts
    (gato_controller.py:90).
    """
    from ..dynamics.rnea import world_wrench_to_ee_joint

    def step(x, u):
        f_l = None
        if wrench_world is not None:
            f_l = world_wrench_to_ee_joint(model, x[: model.nq], wrench_world)
        return euler_step(model, x, u, dt, f_ext_ee=f_l)

    return step


def linearize_dynamics(
    model: RobotModel,
    X,
    U,
    dt: float,
    f_ext_ee: Optional[jnp.ndarray] = None,
    wrench_world: Optional[jnp.ndarray] = None,
):
    """Euler-step Jacobians along a trajectory.

    Args:
      X: (N, nx) states; U: (N-1, nu) controls; f_ext_ee: optional (6,)
        local EE wrench held constant along the horizon; wrench_world:
        optional (6,) world wrench re-mapped per knot (takes precedence).
    Returns (A, B, c) with shapes (N-1, nx, nx), (N-1, nx, nu), (N-1, nx).
    """

    if wrench_world is not None:
        step = make_step_fn(model, dt, wrench_world)
    else:
        def step(x, u):
            return euler_step(model, x, u, dt, f_ext_ee=f_ext_ee)

    def lin_one(x, u):
        A = jax.jacfwd(step, argnums=0)(x, u)
        B = jax.jacfwd(step, argnums=1)(x, u)
        c = step(x, u) - A @ x - B @ u
        return A, B, c

    return jax.vmap(lin_one)(X[:-1], U)


def cost_blocks(model: RobotModel, cfg: CostConfig, X, U, goals):
    """Cost blocks along a trajectory (reference formulation).

    Absolute-variable blocks mirroring osqp_solver.py:103-135: rank-1
    position Hessian ``outer(J^T err, J^T err)``, gradient ``J^T err``.
    Args:
      X: (N, nx); U: (N-1, nu); goals: (N, 3) EE position targets.
    Returns (Q, q, R, r).
    """
    N, nx = X.shape
    nq = model.nq
    nu = model.nu

    def knot(x, goal, is_terminal):
        eep, J = ee_pos_jacobian(model, x[:nq])
        err = eep - goal
        joint_err = J.T @ err  # (nq,)
        scale = jnp.where(
            cfg.regularize,
            1.0 / (jnp.linalg.norm(err) + cfg.eps),
            1.0,
        )
        dQ_mod = cfg.dQ * scale
        R_mod = cfg.R * scale
        Q_mod = jnp.where(is_terminal, cfg.QN, 1.0)

        Qk = jnp.zeros((nx, nx), X.dtype)
        Qk = Qk.at[:nq, :nq].set(Q_mod * jnp.outer(joint_err, joint_err))
        Qk = Qk.at[nq:, nq:].set(dQ_mod * jnp.eye(nq, dtype=X.dtype))
        qk = jnp.concatenate([Q_mod * joint_err, dQ_mod * x[nq:]])
        return Qk, qk, R_mod

    is_term = jnp.arange(N) == N - 1
    Q, q, R_mod = jax.vmap(knot)(X, goals, is_term)
    R = R_mod[:-1, None, None] * jnp.eye(nu, dtype=X.dtype)
    r = R_mod[:-1, None] * U
    return Q, q, R, r


def barrier_terms(model: RobotModel, cfg: CostConfig, q):
    """Joint-range barrier value / gradient / GN Hessian diagonal at q.

    ``q_barrier * sum_j relu(q_j - (hi_j - m))^2 + relu((lo_j + m) - q_j)^2``
    — zero (value, gradient, curvature) strictly inside the margin band,
    so interior trajectories are bit-identical with the barrier on.
    See config.CostConfig.q_barrier.
    """
    w = cfg.q_barrier
    d_hi = jnp.maximum(q - (model.q_upper - cfg.q_barrier_margin), 0.0)
    d_lo = jnp.maximum((model.q_lower + cfg.q_barrier_margin) - q, 0.0)
    val = w * jnp.sum(d_hi * d_hi + d_lo * d_lo)
    grad = 2.0 * w * (d_hi - d_lo)
    hess = 2.0 * w * ((d_hi > 0.0) | (d_lo > 0.0)).astype(q.dtype)
    return val, grad, hess


def cost_blocks_gn(model: RobotModel, cfg: CostConfig, X, U, goals):
    """Delta-variable Gauss-Newton cost blocks (the default formulation).

    Models the same nonlinear cost as :func:`eepos_cost` —
    ``sum Q_mod |ee err|^2 + dQ |v|^2 + R |u|^2`` — as
    ``0.5 d^T H d + g^T d`` around the current trajectory, with the proper
    GN Hessian ``2 Q_mod J^T J`` (rank 3) instead of the reference's
    rank-1 outer product.  Dramatically better conditioned: full Newton
    steps are routinely accepted by the line search.
    """
    N, nx = X.shape
    nq = model.nq
    nu = model.nu

    def knot(x, goal, is_terminal):
        eep, J = ee_pos_jacobian(model, x[:nq])
        err = eep - goal
        scale = jnp.where(
            cfg.regularize,
            1.0 / (jnp.linalg.norm(err) + cfg.eps),
            1.0,
        )
        dQ_mod = cfg.dQ * scale
        R_mod = cfg.R * scale
        Q_mod = jnp.where(is_terminal, cfg.QN, 1.0)

        Qk = jnp.zeros((nx, nx), X.dtype)
        Qk = Qk.at[:nq, :nq].set(2.0 * Q_mod * (J.T @ J))
        Qk = Qk.at[nq:, nq:].set(2.0 * dQ_mod * jnp.eye(nq, dtype=X.dtype))
        g_pos = 2.0 * Q_mod * (J.T @ err)
        if cfg.q_barrier:
            _, gb, hb = barrier_terms(model, cfg, x[:nq])
            Qk = Qk.at[jnp.arange(nq), jnp.arange(nq)].add(Q_mod * hb)
            g_pos = g_pos + Q_mod * gb
        qk = jnp.concatenate([g_pos, 2.0 * dQ_mod * x[nq:]])
        return Qk, qk, R_mod

    is_term = jnp.arange(N) == N - 1
    Q, q, R_mod = jax.vmap(knot)(X, goals, is_term)
    R = 2.0 * R_mod[:-1, None, None] * jnp.eye(nu, dtype=X.dtype)
    r = 2.0 * R_mod[:-1, None] * U
    return Q, q, R, r


def dynamics_defects(
    model: RobotModel,
    X,
    U,
    dt: float,
    f_ext_ee: Optional[jnp.ndarray] = None,
    wrench_world: Optional[jnp.ndarray] = None,
):
    """Per-knot integrator defects ``d_k = f(x_k, u_k) - x_{k+1}``."""
    if wrench_world is not None:
        step_fn = make_step_fn(model, dt, wrench_world)
    else:
        step_fn = lambda x, u: euler_step(model, x, u, dt, f_ext_ee=f_ext_ee)
    return jax.vmap(step_fn)(X[:-1], U) - X[1:]


def build_qp(
    model: RobotModel,
    cfg: CostConfig,
    X,
    U,
    goals,
    dt: float,
    f_ext_ee: Optional[jnp.ndarray] = None,
    wrench_world: Optional[jnp.ndarray] = None,
) -> QPBlocks:
    """Absolute-variable QP blocks (reference formulation).

    The returned QP is over the trajectory variables themselves; its
    affine term ``c`` is the linearization residual (osqp_solver.py:81).
    """
    A, B, c = linearize_dynamics(
        model, X, U, dt, f_ext_ee=f_ext_ee, wrench_world=wrench_world
    )
    Q, q, R, r = cost_blocks(model, cfg, X, U, goals)
    return QPBlocks(A=A, B=B, c=c, Q=Q, q=q, R=R, r=r)


def build_qp_gn(
    model: RobotModel,
    cfg: CostConfig,
    X,
    U,
    goals,
    dt: float,
    f_ext_ee: Optional[jnp.ndarray] = None,
    wrench_world: Optional[jnp.ndarray] = None,
) -> QPBlocks:
    """Delta-variable Gauss-Newton QP blocks (default formulation).

    The QP is over steps ``(dX, dU)``; the dynamics affine term is the
    integrator defect, and the initial condition is ``xs - x_0``.
    """
    A, B, c = linearize_dynamics(
        model, X, U, dt, f_ext_ee=f_ext_ee, wrench_world=wrench_world
    )
    # Defect d_k = f(x_k, u_k) - x_{k+1}, recovered from the residual c
    # without re-evaluating the dynamics.
    fx = c + jnp.einsum("kij,kj->ki", A, X[:-1]) + jnp.einsum(
        "kij,kj->ki", B, U
    )
    d = fx - X[1:]
    Q, q, R, r = cost_blocks_gn(model, cfg, X, U, goals)
    return QPBlocks(A=A, B=B, c=d, Q=Q, q=q, R=R, r=r)


# ---------------------------------------------------------------------------
# Nonlinear merit components (reference: osqp_sqp.py:13-47).
# ---------------------------------------------------------------------------

def eepos_cost(model: RobotModel, cfg: CostConfig, X, U, goals):
    """Nonlinear tracking cost, matching osqp_sqp.py:13-30 exactly.

    Note: unlike the QP blocks, the merit cost does NOT apply the adaptive
    1/(|err|+eps) scaling (osqp_sqp.py:27-29 uses raw dQ/R).
    Returns (qcost, vcost, ucost) scalars (batched under vmap).
    """
    nq = model.nq

    def knot(x, goal, is_terminal):
        from ..dynamics.kinematics import ee_pos

        err = ee_pos(model, x[:nq]) - goal
        Q_mod = jnp.where(is_terminal, cfg.QN, 1.0)
        pos_cost = err @ err
        # Joint-range barrier ("gn" formulation only — the "reference"
        # merit must keep matching the osqp_sqp.py restatement).
        if cfg.q_barrier and cfg.formulation == "gn":
            pos_cost = pos_cost + barrier_terms(model, cfg, x[:nq])[0]
        return Q_mod * pos_cost, cfg.dQ * (x[nq:] @ x[nq:])

    N = X.shape[0]
    is_term = jnp.arange(N) == N - 1
    qc, vc = jax.vmap(knot)(X, goals, is_term)
    ucost = cfg.R * jnp.sum(U * U)
    return jnp.sum(qc), jnp.sum(vc), ucost


def integrator_err(
    model: RobotModel,
    X,
    U,
    dt: float,
    f_ext_ee: Optional[jnp.ndarray] = None,
    wrench_world: Optional[jnp.ndarray] = None,
):
    """Sum of per-knot Euler-defect norms (osqp_sqp.py:32-47).

    The reference sums ||q_next - q_{k+1}|| + ||v_next - v_{k+1}|| per knot.
    """
    nq = model.nq
    if wrench_world is not None:
        step_fn = make_step_fn(model, dt, wrench_world)
    else:
        step_fn = lambda x, u: euler_step(model, x, u, dt, f_ext_ee=f_ext_ee)

    def knot(x, u, x_next):
        pred = step_fn(x, u)
        dq = pred[:nq] - x_next[:nq]
        dv = pred[nq:] - x_next[nq:]
        return jnp.linalg.norm(dq) + jnp.linalg.norm(dv)

    errs = jax.vmap(knot)(X[:-1], U, X[1:])
    return jnp.sum(errs)
