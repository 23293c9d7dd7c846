"""Lane-major batched SQP solver — the GPU production solver.

The lane-major structure-of-arrays SQP (ops/lane_rbd.py, ops/lane_sqp.py)
as plain traceable JAX: every quantity is a (B,)-lane vector, the knots
fold into the lane axis for linearization and the line search, and the
Riccati sweep is a scan of batched 12x12 products with a
square-root-free LDL^T on each 6x6 Quu and re-symmetrizes S every knot,
so it stays stable in float32 at N=64; its 12x12 products run at
"highest" precision (no TF32).  solvers/select.py picks it on a GPU
(PERF.md: the faster of the two plain solvers on the H100);
tests/test_lane_sqp.py pins its numerics against the vmap solver.  Same semantics: fixed iteration count with
per-lane masked updates, 8-alpha merit line search (osqp_sqp.py:49-93),
per-lane Levenberg rho state (the reference's resetRho analog,
gato_controller.py:131-138).
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import lane_rbd as LR
from ..ops import lane_sqp as LS
from .sqp import SolverState, SQPResult, SQPStats


def accept_step(sqp_cfg: SQPConfig, merits, base, X, U, dX, dU, done, rho):
    """First-acceptance line search and the masked per-lane update.

    ``merits`` (num_alphas, B) are the candidates' merits, ``base`` (B,)
    the current trajectory's.  Alphas are descending, so the first
    candidate with ``merit <= base`` wins (osqp_sqp.py:49-74); a lane
    with none rejects the step and raises its Levenberg rho; a lane whose
    accepted step is shorter than ``step_tol`` is done and freezes.
    Returns (X, U, rho, done, logged alpha, step norm).
    """
    alphas = 0.5 ** jnp.arange(sqp_cfg.num_alphas, dtype=merits.dtype)
    ok = merits <= base[None]
    any_ok = jnp.any(ok, axis=0)
    alpha = jnp.where(any_ok, alphas[jnp.argmax(ok, axis=0)], 0.0)
    take = jnp.logical_and(~done, alpha > 0.0)
    scale = jnp.where(take, alpha, 0.0)
    step_norm = scale * jnp.sqrt(
        jnp.sum(dX * dX, axis=(0, 1)) + jnp.sum(dU * dU, axis=(0, 1))
    )
    rejected = jnp.logical_and(~done, ~any_ok)
    rho = jnp.clip(
        jnp.where(rejected, rho * sqp_cfg.rho_factor, rho),
        sqp_cfg.rho,
        sqp_cfg.rho_max,
    )
    return (
        X + scale * dX,
        U + scale * dU,
        rho,
        jnp.logical_or(done, jnp.logical_and(take, step_norm < sqp_cfg.step_tol)),
        jnp.where(done, 0.0, alpha),
        step_norm,
    )


def batch_solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs_b,
    goals_b,
    X_b,
    U_b,
    state: Optional[SolverState] = None,
    wrench_world_batch=None,
) -> SQPResult:
    """Lane-batched SQP solve; array API identical to sqp.batch_solve.

    xs_b: (B, 12), goals_b: (B, N, 3), X_b: (B, N, 12), U_b: (B, N-1, 6),
    wrench_world_batch: (B, 6) or None.
    """
    if cost_cfg.formulation != "gn":
        raise ValueError("lane solver implements the 'gn' formulation only")
    sm = LR.static_model(model)
    B = xs_b.shape[0]
    dtype = X_b.dtype
    if state is None:
        state = SolverState.init(sqp_cfg, (B,))
    rho = state.rho.astype(dtype)

    # To lane-major layout.
    X = jnp.transpose(X_b, (1, 2, 0))      # (N, 12, B)
    U = jnp.transpose(U_b, (1, 2, 0))      # (N-1, 6, B)
    goals = jnp.transpose(goals_b, (1, 2, 0))  # (N, 3, B)
    xs = xs_b.T                            # (12, B)
    w = None
    if wrench_world_batch is not None:
        w = wrench_world_batch.T           # (6, B)

    X = X.at[0].set(xs)
    alf = jnp.concatenate([
        0.5 ** jnp.arange(sqp_cfg.num_alphas, dtype=dtype),
        jnp.zeros(1, dtype),  # alpha = 0: the base merit
    ])

    def iteration(it, carry):
        X, U, rho, done, iters, step_log, alpha_log = carry
        blocks = LS.build_blocks(sm, cost_cfg, X, U, goals, dt, wrench=w)
        dX, dU = LS.riccati(blocks, jnp.zeros_like(xs), rho)
        Xc = X[None] + alf[:, None, None, None] * dX[None]
        Uc = U[None] + alf[:, None, None, None] * dU[None]
        merits = LS.merit_batch(
            sm, cost_cfg, sqp_cfg.merit_mu, Xc, Uc, goals, X[0], dt, wrench=w
        )  # (num_alphas + 1, B)
        iters = iters + jnp.where(done, 0, 1).astype(jnp.int32)
        X, U, rho, done, alpha, step_norm = accept_step(
            sqp_cfg, merits[:-1], merits[-1], X, U, dX, dU, done, rho
        )
        return (X, U, rho, done, iters, step_log.at[it].set(step_norm),
                alpha_log.at[it].set(alpha))

    # One traced iteration, looped: half the program of an unrolled pair.
    X, U, rho, _, iters, step_log, alpha_log = jax.lax.fori_loop(
        0, sqp_cfg.max_iters, iteration,
        (X, U, rho, jnp.zeros(B, bool), jnp.zeros(B, jnp.int32),
         jnp.zeros((sqp_cfg.max_iters, B), dtype),
         jnp.zeros((sqp_cfg.max_iters, B), dtype)),
    )

    return SQPResult(
        X=jnp.transpose(X, (2, 0, 1)),
        U=jnp.transpose(U, (2, 0, 1)),
        state=SolverState(rho=rho.astype(state.rho.dtype)),
        stats=SQPStats(
            iterations=iters,
            step_sizes=step_log.T,
            alphas=alpha_log.T,
        ),
    )
