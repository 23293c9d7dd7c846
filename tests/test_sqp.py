"""SQP layer tests: oracle parity, descent, batching (SURVEY.md section 4).

The oracle is a plain numpy/Python re-statement of the reference SQP loop
(osqp_sqp.py:49-93) using the dense-KKT QP oracle from test_riccati —
straight-line control flow against which the jitted masked-control-flow
implementation must agree exactly.
"""
import jax
import pytest
import jax.numpy as jnp
import numpy as np

from indy7_mpc.config import CostConfig, SQPConfig
from indy7_mpc.dynamics import ee_pos
from indy7_mpc.ops import kkt
from indy7_mpc.solvers import sqp as sqp_mod

from test_riccati import dense_solve


def oracle_sqp(model, cost_cfg, sqp_cfg, dt, xs, goals, X, U):
    """Reference-style SQP loop in plain Python + dense KKT."""
    X = np.asarray(X).copy()
    U = np.asarray(U).copy()
    X[0] = np.asarray(xs)
    rho = sqp_cfg.rho
    alphas = [0.5**i for i in range(sqp_cfg.num_alphas)]

    def merit(Xc, Uc, x0_prev):
        qc, vc, uc = kkt.eepos_cost(
            model, cost_cfg, jnp.asarray(Xc), jnp.asarray(Uc), goals
        )
        cv = kkt.integrator_err(model, jnp.asarray(Xc), jnp.asarray(Uc), dt)
        cv = float(cv) + np.linalg.norm(Xc[0] - x0_prev)
        return float(qc + vc + uc) + sqp_cfg.merit_mu * cv

    for _ in range(sqp_cfg.max_iters):
        blocks = kkt.build_qp(
            model, cost_cfg, jnp.asarray(X), jnp.asarray(U), goals, dt
        )
        Xs, Us = dense_solve(blocks, np.asarray(xs), rho)
        base = merit(X, U, X[0].copy())
        chosen = 0.0
        for a in alphas:
            Xc = X + a * (Xs - X)
            Uc = U + a * (Us - U)
            if merit(Xc, Uc, X[0].copy()) <= base:
                chosen = a
                break
        if chosen == 0.0:
            continue
        step = chosen * np.sqrt(np.sum((Xs - X) ** 2) + np.sum((Us - U) ** 2))
        X = X + chosen * (Xs - X)
        U = U + chosen * (Us - U)
        if step < sqp_cfg.step_tol:
            break
    return X, U


def _setup(model, N=12, dt=0.01):
    xs = jnp.zeros(12, jnp.float64)
    goal = ee_pos(model, jnp.zeros(6)) + jnp.asarray([0.05, -0.08, 0.06])
    goals = jnp.tile(goal, (N, 1))
    X = jnp.zeros((N, 12), jnp.float64)
    U = jnp.zeros((N - 1, 6), jnp.float64)
    return xs, goals, X, U


@pytest.mark.slow
def test_sqp_matches_oracle(model64):
    m = model64
    # Reference formulation: the oracle below re-states osqp_sqp.py's loop
    # over the absolute-variable QP (osqp_solver.py semantics).
    cost_cfg = CostConfig(formulation="reference")
    # rho_factor=1 disables Levenberg adaptation so the oracle (which never
    # adapts, like osqp_sqp.py) follows the identical iteration sequence.
    sqp_cfg = SQPConfig(max_iters=3, rho=1e-6, rho_factor=1.0)
    dt = 0.01
    xs, goals, X, U = _setup(m)

    res = jax.jit(
        lambda xs, g, X, U: sqp_mod.solve(m, cost_cfg, sqp_cfg, dt, xs, g, X, U)
    )(xs, goals, X, U)
    Xo, Uo = oracle_sqp(m, cost_cfg, sqp_cfg, dt, xs, goals, X, U)
    np.testing.assert_allclose(np.asarray(res.X), Xo, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.U), Uo, rtol=1e-5, atol=1e-7)


@pytest.mark.slow
def test_sqp_reduces_tracking_cost(model64):
    m = model64
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=6)
    dt = 0.01
    xs, goals, X, U = _setup(m, N=16)

    def total_cost(X, U):
        qc, vc, uc = kkt.eepos_cost(m, cost_cfg, X, U, goals)
        return float(qc + vc + uc)

    before = total_cost(X.at[0].set(xs), U)
    res = sqp_mod.solve(m, cost_cfg, sqp_cfg, dt, xs, goals, X, U)
    after = total_cost(res.X, res.U)
    assert after < before, (before, after)
    assert int(res.stats.iterations) >= 1
    # The optimized trajectory should move the terminal EE toward the goal.
    ee0 = np.asarray(ee_pos(m, np.asarray(X[-1, :6])))
    eeT = np.asarray(ee_pos(m, np.asarray(res.X[-1, :6])))
    g = np.asarray(goals[0])
    assert np.linalg.norm(eeT - g) < np.linalg.norm(ee0 - g)


@pytest.mark.slow  # determinism also covered by the quick
# test_sampled_mpc_deterministic; this f64 B-lane compile is heavy
def test_batch_solve_lane_determinism(model64):
    """Identical lanes give identical trajectories — the generalization of
    the reference's in-loop allclose assert (gato_mpc_batch.py:124-134)."""
    m = model64
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    dt = 0.01
    xs, goals, X, U = _setup(m)
    B = 4
    res = jax.jit(
        lambda xs, g, X, U: sqp_mod.batch_solve(
            m, cost_cfg, sqp_cfg, dt, xs, g, X, U
        )
    )(
        jnp.tile(xs, (B, 1)),
        jnp.tile(goals, (B, 1, 1)),
        jnp.tile(X, (B, 1, 1)),
        jnp.tile(U, (B, 1, 1)),
    )
    for i in range(1, B):
        np.testing.assert_allclose(
            np.asarray(res.X[i]), np.asarray(res.X[0]), rtol=1e-5, atol=1e-5
        )
    # single-lane result matches lane 0
    res1 = sqp_mod.solve(m, cost_cfg, sqp_cfg, dt, xs, goals, X, U)
    np.testing.assert_allclose(
        np.asarray(res.X[0]), np.asarray(res1.X), rtol=1e-6, atol=1e-8
    )


@pytest.mark.slow
def test_batch_solve_wrench_hypotheses_differ(model64):
    """Different wrench hypotheses must produce different lane solutions."""
    m = model64
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    dt = 0.01
    xs, goals, X, U = _setup(m)
    B = 3
    wrenches = jnp.stack(
        [
            jnp.zeros(6),
            jnp.asarray([30.0, 0.0, 0.0, 0.0, 0.0, 0.0]),
            jnp.asarray([0.0, 0.0, -50.0, 0.0, 0.0, 0.0]),
        ]
    )
    res = sqp_mod.batch_solve(
        m,
        cost_cfg,
        sqp_cfg,
        dt,
        jnp.tile(xs, (B, 1)),
        jnp.tile(goals, (B, 1, 1)),
        jnp.tile(X, (B, 1, 1)),
        jnp.tile(U, (B, 1, 1)),
        wrench_world_batch=wrenches,
    )
    d01 = float(jnp.max(jnp.abs(res.U[0] - res.U[1])))
    d02 = float(jnp.max(jnp.abs(res.U[0] - res.U[2])))
    assert d01 > 1e-4 and d02 > 1e-4
