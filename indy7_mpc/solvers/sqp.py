"""Batched SQP trajectory optimizer (jit/vmap/shard-ready).

The readable equivalent of both reference solver backends:
  * the CPU SQP outer loop (/root/reference/src/osqp_sqp.py:49-93) —
    linearize, QP solve, merit line search over 8 halving alphas
    (mu = 10), step-norm exit at 1e-3, iteration cap;
  * the CUDA batched solver's role (``bindings.batch_sqp`` —
    gato_controller.py:93-103): B independent lanes solved in one jitted
    program, each with its own wrench hypothesis and warm start.  The
    batch size is a plain vmap axis instead of 9 compiled template classes
    (gato_controller.py:53-63), and lanes shard over a device mesh.

Control flow is fixed-shape: a static Python loop over ``max_iters`` with
masked updates, so jit sees no data-dependent branches.  Per-lane solver
state (rho) is an explicit pytree, replacing the reference's stateful
``reset/resetRho/resetLambda`` object API (gato_controller.py:131-138).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..config import CostConfig, SQPConfig
from ..models.robot import RobotModel
from ..ops import admm, kkt, pcg, riccati, riccati_pscan


class SolverState(NamedTuple):
    """Per-lane solver state carried across ticks (reference: rho/lambda).

    Under ``qp_backend="admm"`` the state also carries the ADMM primal
    iterate and constraint multipliers, mirroring OSQP's warm-start
    design (the reference reuses one OSQP object across SQP iterations
    and ticks so x/z/y persist, osqp_solver.py:39-41, 137-143; its
    ``resetLambda`` analog is simply dropping this state,
    gato_controller.py:131-138).  ``None`` for the direct backends.
    """

    rho: jnp.ndarray  # () per lane
    admm_z: Optional[jnp.ndarray] = None  # (N, nx+nu) primal iterate
    admm_y: Optional[jnp.ndarray] = None  # (N, nx) constraint duals

    @staticmethod
    def init(cfg: SQPConfig, batch_shape=()):
        return SolverState(rho=jnp.full(batch_shape, cfg.rho, jnp.float32))


class SQPStats(NamedTuple):
    """Per-solve diagnostics mirroring the reference's stats schema
    (gato_controller.py:70-75, 96-101)."""

    iterations: jnp.ndarray   # () number of accepted QP iterations
    step_sizes: jnp.ndarray   # (max_iters,) ||alpha * dz|| per iteration
    alphas: jnp.ndarray       # (max_iters,) line-search alphas (0 = reject)
    # (max_iters,) inner-QP iterations per SQP iteration for the iterative
    # backends: CG iterations under qp_backend="pcg" (the reference's
    # pcg_stats[i].pcg_iterations), ADMM iterations under "admm" (OSQP's
    # iteration count); None under the direct Riccati backends.
    pcg_iters: Optional[jnp.ndarray] = None


class SQPResult(NamedTuple):
    X: jnp.ndarray
    U: jnp.ndarray
    state: SolverState
    stats: SQPStats


def merit(model, cost_cfg, mu, X, U, goals, x0_prev, dt, wrench_world=None):
    """Merit = nonlinear cost + mu * constraint violation (osqp_sqp.py:49-66)."""
    qc, vc, uc = kkt.eepos_cost(model, cost_cfg, X, U, goals)
    cv = kkt.integrator_err(model, X, U, dt, wrench_world=wrench_world)
    cv = cv + jnp.linalg.norm(X[0] - x0_prev)
    return qc + vc + uc + mu * cv


def _alphas(cfg: SQPConfig, dtype):
    return 0.5 ** jnp.arange(cfg.num_alphas, dtype=dtype)


def solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs,
    goals,
    X,
    U,
    state: Optional[SolverState] = None,
    wrench_world=None,
) -> SQPResult:
    """One lane's SQP solve.  Its 12x12 block products run at float32
    ("highest") precision: on a GPU the default would round them to TF32
    (~3 decimal digits), which the Riccati recursion amplifies."""
    with jax.default_matmul_precision("highest"):
        return _solve(model, cost_cfg, sqp_cfg, dt, xs, goals, X, U, state,
                      wrench_world)


def _solve(model, cost_cfg, sqp_cfg, dt, xs, goals, X, U, state,
           wrench_world) -> SQPResult:
    if state is None:
        state = SolverState.init(sqp_cfg)
    rho = state.rho.astype(X.dtype)
    X = X.at[0].set(xs)  # pin initial state (gato_controller.py:218)

    alphas = _alphas(sqp_cfg, X.dtype)
    mu = sqp_cfg.merit_mu

    done = jnp.asarray(False)
    iters = jnp.asarray(0, jnp.int32)
    step_sizes = jnp.zeros(sqp_cfg.max_iters, X.dtype)
    alpha_log = jnp.zeros(sqp_cfg.max_iters, X.dtype)
    iterative = sqp_cfg.qp_backend in ("pcg", "admm")
    pcg_log = jnp.zeros(sqp_cfg.max_iters, jnp.int32) if iterative else None

    # ADMM warm-start surface: primal/dual iterates persist across SQP
    # iterations AND across calls via SolverState (OSQP's object reuse,
    # osqp_solver.py:137-143).  Python-level cell; the loop is static.
    admm_warm = {"z": state.admm_z, "y": state.admm_y}

    def qp_solve(blocks, x_init):
        if sqp_cfg.qp_backend == "pcg":
            sol = pcg.solve(
                blocks, x_init, rho,
                primal_reg=sqp_cfg.pcg_primal_reg,
                tol=sqp_cfg.pcg_tol,
                max_iters=sqp_cfg.pcg_max_iters,
            )
            return sol.X, sol.U, sol.iterations
        if sqp_cfg.qp_backend == "admm":
            sol = admm.solve(
                blocks, x_init, rho,
                sigma=sqp_cfg.admm_sigma,
                rho_admm=sqp_cfg.admm_rho,
                alpha=sqp_cfg.admm_alpha,
                eps_abs=sqp_cfg.admm_eps,
                eps_rel=sqp_cfg.admm_eps,
                max_iters=sqp_cfg.admm_max_iters,
                z0=admm_warm["z"],
                y0=admm_warm["y"],
            )
            admm_warm["z"], admm_warm["y"] = sol.z, sol.y
            return sol.X, sol.U, sol.iterations
        if sqp_cfg.qp_backend == "riccati_pscan":
            sol = riccati_pscan.solve_pscan(blocks, x_init, rho)
        else:
            sol = riccati.solve(blocks, x_init, rho)
        return sol.X, sol.U, None

    def merit_of(Xc, Uc, x0_prev):
        return merit(
            model, cost_cfg, mu, Xc, Uc, goals, x0_prev, dt, wrench_world
        )

    gn = cost_cfg.formulation == "gn"
    for it in range(sqp_cfg.max_iters):
        if gn:
            blocks = kkt.build_qp_gn(
                model, cost_cfg, X, U, goals, dt, wrench_world=wrench_world
            )
            dX, dU, cg_it = qp_solve(blocks, xs - X[0])
        else:
            blocks = kkt.build_qp(
                model, cost_cfg, X, U, goals, dt, wrench_world=wrench_world
            )
            Xq, Uq, cg_it = qp_solve(blocks, xs)
            dX = Xq - X
            dU = Uq - U
        if iterative:
            pcg_log = pcg_log.at[it].set(
                jnp.where(done, 0, cg_it).astype(jnp.int32)
            )

        base = merit_of(X, U, X[0])

        def cand_merit(alpha):
            return merit_of(X + alpha * dX, U + alpha * dU, X[0])

        merits = jax.vmap(cand_merit)(alphas)
        ok = merits <= base
        any_ok = jnp.any(ok)
        first = jnp.argmax(ok)  # alphas are descending; first accepted wins
        alpha = jnp.where(any_ok, alphas[first], 0.0)

        # Masked update: once done (or rejected), the trajectory freezes.
        take = jnp.logical_and(~done, alpha > 0.0)
        scale = jnp.where(take, alpha, 0.0)
        X = X + scale * dX
        U = U + scale * dU

        step_norm = scale * jnp.sqrt(
            jnp.sum(dX * dX) + jnp.sum(dU * dU)
        )
        step_sizes = step_sizes.at[it].set(step_norm)
        alpha_log = alpha_log.at[it].set(jnp.where(done, 0.0, alpha))
        iters = iters + jnp.where(done, 0, 1).astype(jnp.int32)

        # Levenberg rho: raise on rejection, keep on acceptance.
        rejected = jnp.logical_and(~done, ~any_ok)
        rho = jnp.clip(
            jnp.where(rejected, rho * sqp_cfg.rho_factor, rho),
            sqp_cfg.rho,
            sqp_cfg.rho_max,
        )

        done = jnp.logical_or(
            done, jnp.logical_and(take, step_norm < sqp_cfg.step_tol)
        )

    return SQPResult(
        X=X,
        U=U,
        state=SolverState(
            rho=rho.astype(state.rho.dtype),
            admm_z=admm_warm["z"],
            admm_y=admm_warm["y"],
        ),
        stats=SQPStats(
            iterations=iters,
            step_sizes=step_sizes,
            alphas=alpha_log,
            pcg_iters=pcg_log,
        ),
    )


def batch_solve(
    model: RobotModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs_batch,
    goals_batch,
    X_batch,
    U_batch,
    state: Optional[SolverState] = None,
    wrench_world_batch=None,
) -> SQPResult:
    """vmapped lane-batched solve — the ``SQPSolverfloat_B.solve`` analog.

    All array args carry a leading lane axis; ``wrench_world_batch`` is
    (B, 6) or None.  Batch size is a runtime shape, not a template.
    """
    B = xs_batch.shape[0]
    if state is None:
        state = SolverState.init(sqp_cfg, (B,))

    def one(xs, goals, X, U, st, w):
        return solve(
            model, cost_cfg, sqp_cfg, dt, xs, goals, X, U, st, wrench_world=w
        )

    if wrench_world_batch is None:
        fn = lambda xs, g, X, U, st: one(xs, g, X, U, st, None)
        return jax.vmap(fn)(xs_batch, goals_batch, X_batch, U_batch, state)
    return jax.vmap(one)(
        xs_batch, goals_batch, X_batch, U_batch, state, wrench_world_batch
    )
