"""ADMM (OSQP-algorithm) backend vs the Riccati sweep and dense oracle.

The reference's CPU path solves its KKT systems with OSQP — ADMM on a
sparse CSC system (/root/reference/src/osqp_solver.py:39-41, 137-143).
ops/admm.py is that algorithm on the structured blocks; it must
agree with the exact backends to solver tolerance and plug into the SQP
outer loop as qp_backend="admm".
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import CostConfig
from indy7_mpc.ops import admm, dense_kkt, kkt, riccati

from test_riccati import random_blocks


@pytest.mark.parametrize("N,nx,nu", [(8, 12, 6), (32, 12, 6), (5, 4, 2)])
def test_admm_matches_riccati(rng, N, nx, nu):
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    ric = riccati.solve(blocks, xs, rho)
    sol = jax.jit(
        lambda b, x: admm.solve(b, x, rho, eps_abs=1e-10, eps_rel=1e-10,
                                max_iters=4000)
    )(blocks, xs)
    assert int(sol.iterations) > 0
    np.testing.assert_allclose(np.asarray(sol.X), np.asarray(ric.X),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sol.U), np.asarray(ric.U),
                               rtol=1e-6, atol=1e-6)


def test_admm_matches_dense_oracle(rng):
    N, nx, nu = 16, 12, 6
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    sol = admm.solve(blocks, xs, rho, eps_abs=1e-10, eps_rel=1e-10,
                     max_iters=4000)
    Xd, Ud = dense_kkt.solve(blocks, np.asarray(xs), rho)
    np.testing.assert_allclose(np.asarray(sol.X), Xd, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sol.U), Ud, rtol=1e-6, atol=1e-6)


def test_admm_constraint_feasibility(rng):
    """The ADMM solution satisfies the equality constraints (OSQP's
    primal-residual exit criterion): x0 pin + dynamics rows."""
    N, nx, nu = 12, 12, 6
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    sol = admm.solve(blocks, xs, rho, eps_abs=1e-9, eps_rel=1e-9,
                     max_iters=4000)
    np.testing.assert_allclose(np.asarray(sol.X[0]), np.asarray(xs),
                               atol=1e-7)
    for k in range(N - 1):
        lhs = blocks.A[k] @ sol.X[k] + blocks.B[k] @ sol.U[k] + blocks.c[k]
        np.testing.assert_allclose(np.asarray(lhs),
                                   np.asarray(sol.X[k + 1]), atol=1e-7)
    assert float(sol.r_prim) < 1e-7


def test_admm_warm_start_reduces_iterations(rng):
    """Warm starting from the solution converges in ~0 iterations — the
    OSQP warm-start surface the reference relies on across SQP iterations
    (osqp_solver.py:137-143)."""
    N, nx, nu = 10, 12, 6
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    cold = admm.solve(blocks, xs, rho, eps_abs=1e-9, eps_rel=1e-9,
                      max_iters=4000)
    z0 = jnp.concatenate(
        [cold.X, jnp.concatenate([cold.U, jnp.zeros((1, nu))], axis=0)],
        axis=1,
    )
    warm = admm.solve(blocks, xs, rho, eps_abs=1e-9, eps_rel=1e-9,
                      max_iters=4000, z0=z0, y0=cold.y)
    assert int(warm.iterations) < int(cold.iterations) // 4


def test_admm_batched_lanes(rng):
    N, nx, nu, B = 8, 12, 6, 4
    rho = 1e-6
    all_blocks = [random_blocks(rng, N, nx, nu, rho) for _ in range(B)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *all_blocks)
    xs = jnp.asarray(rng.normal(size=(B, nx)))
    vsolve = jax.jit(jax.vmap(
        lambda b, x: admm.solve(b, x, rho, eps_abs=1e-10, eps_rel=1e-10,
                                max_iters=4000)
    ))
    sol = vsolve(stacked, xs)
    for i in range(B):
        ric = riccati.solve(all_blocks[i], xs[i], rho)
        np.testing.assert_allclose(np.asarray(sol.X[i]), np.asarray(ric.X),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_sqp_with_admm_backend_matches_riccati(model64, rng):
    """Full SQP solve with the ADMM backend on the real robot: accepted
    steps and final merit within the inexact-QP slack of the Riccati
    backend; iteration stats populate (OSQP parity)."""
    from indy7_mpc.config import SQPConfig
    from indy7_mpc.solvers import sqp as sqp_mod

    m = model64
    N, dt = 8, 0.01
    cost_cfg = CostConfig()
    goals = jnp.tile(jnp.asarray([0.3, 0.2, 0.6]), (N, 1))
    xs = jnp.asarray(rng.normal(size=12) * 0.1)
    X = jnp.tile(xs, (N, 1))
    U = jnp.zeros((N - 1, 6))

    cfg_r = SQPConfig(max_iters=2)
    cfg_a = SQPConfig(max_iters=2, qp_backend="admm", admm_eps=1e-9,
                      admm_max_iters=2000)
    res_r = sqp_mod.solve(m, cost_cfg, cfg_r, dt, xs, goals, X, U)
    res_a = sqp_mod.solve(m, cost_cfg, cfg_a, dt, xs, goals, X, U)

    assert res_a.stats.pcg_iters is not None
    assert int(res_a.stats.pcg_iters[0]) > 0

    def final_merit(res):
        return float(sqp_mod.merit(
            m, cost_cfg, cfg_r.merit_mu, res.X, res.U, goals, xs, dt
        ))

    mr, ma = final_merit(res_r), final_merit(res_a)
    assert ma <= mr * 1.05 + 1e-6
    np.testing.assert_allclose(np.asarray(res_a.X), np.asarray(res_r.X),
                               rtol=1e-3, atol=1e-4)


@pytest.mark.slow  # second ADMM-config compile; ADMM numerics are
# covered by the quick oracle tests above
def test_sqp_admm_state_warm_start_reduces_iterations(model64, rng):
    """SolverState carries the ADMM primal/dual iterates across solves
    (OSQP's object-reuse warm start, osqp_solver.py:137-143): re-solving
    a slightly-moved problem from the returned state must cost fewer
    ADMM iterations than a cold start, and reach the same solution."""
    from indy7_mpc.config import SQPConfig
    from indy7_mpc.solvers import sqp as sqp_mod

    m = model64
    N, dt = 6, 0.01
    cost_cfg = CostConfig()
    goals = jnp.tile(jnp.asarray([0.3, 0.2, 0.6]), (N, 1))
    xs = jnp.asarray(rng.normal(size=12) * 0.1)
    X = jnp.tile(xs, (N, 1))
    U = jnp.zeros((N - 1, 6))
    cfg = SQPConfig(max_iters=1, qp_backend="admm", admm_eps=1e-8,
                    admm_max_iters=4000)

    res1 = sqp_mod.solve(m, cost_cfg, cfg, dt, xs, goals, X, U)
    assert res1.state.admm_z is not None and res1.state.admm_y is not None

    # Receding-horizon style next tick: state moved slightly.
    xs2 = xs + 1e-3
    cold = sqp_mod.solve(m, cost_cfg, cfg, dt, xs2, goals, res1.X, res1.U)
    warm = sqp_mod.solve(m, cost_cfg, cfg, dt, xs2, goals, res1.X, res1.U,
                         state=res1.state)
    it_cold = int(cold.stats.pcg_iters[0])
    it_warm = int(warm.stats.pcg_iters[0])
    assert it_warm < it_cold, (it_warm, it_cold)
    np.testing.assert_allclose(np.asarray(warm.X), np.asarray(cold.X),
                               rtol=1e-4, atol=1e-6)
