"""Schur-complement PCG backend vs the Riccati sweep and dense oracle.

The reference's CUDA solver solves its KKT systems by preconditioned CG
on the dual (pcg_stats, gato_controller.py:98-99); ops/pcg.py is that
algorithm, batched.  Both backends must agree with each other and with
the dense KKT factorization to solver tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import CostConfig
from indy7_mpc.ops import dense_kkt, kkt, pcg, riccati

from test_riccati import random_blocks


@pytest.mark.parametrize("N,nx,nu", [(8, 12, 6), (32, 12, 6), (5, 4, 2)])
def test_pcg_matches_riccati(rng, N, nx, nu):
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)  # Q already PD
    xs = jnp.asarray(rng.normal(size=nx))
    ric = riccati.solve(blocks, xs, rho)
    sol = jax.jit(
        lambda b, x: pcg.solve(b, x, rho, primal_reg=0.0, tol=1e-13,
                               max_iters=400)
    )(blocks, xs)
    assert int(sol.iterations) > 0
    np.testing.assert_allclose(np.asarray(sol.X), np.asarray(ric.X),
                               rtol=1e-7, atol=1e-8)
    np.testing.assert_allclose(np.asarray(sol.U), np.asarray(ric.U),
                               rtol=1e-7, atol=1e-8)


def test_pcg_matches_dense_oracle(rng):
    N, nx, nu = 16, 12, 6
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    sol = pcg.solve(blocks, xs, rho, primal_reg=0.0, tol=1e-13, max_iters=400)
    Xd, Ud = dense_kkt.solve(blocks, np.asarray(xs), rho)
    np.testing.assert_allclose(np.asarray(sol.X), Xd, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sol.U), Ud, rtol=1e-6, atol=1e-7)


def test_pcg_batched_lanes(rng):
    N, nx, nu, B = 8, 12, 6, 4
    rho = 1e-6
    all_blocks = [random_blocks(rng, N, nx, nu, rho) for _ in range(B)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *all_blocks)
    xs = jnp.asarray(rng.normal(size=(B, nx)))
    vsolve = jax.jit(jax.vmap(
        lambda b, x: pcg.solve(b, x, rho, primal_reg=0.0, tol=1e-13,
                               max_iters=400)
    ))
    sol = vsolve(stacked, xs)
    for i in range(B):
        ric = riccati.solve(all_blocks[i], xs[i], rho)
        np.testing.assert_allclose(np.asarray(sol.X[i]), np.asarray(ric.X),
                                   rtol=1e-7, atol=1e-8)


def test_pcg_real_robot_blocks(model64, rng):
    """Rank-deficient GN position Hessians: regularize Q identically on
    both backends, then they must agree on the real-robot KKT system."""
    cfg = CostConfig()
    N, dt, reg = 16, 0.01, 1e-4
    m = model64
    X0 = jnp.asarray(rng.normal(size=(N, 12)) * 0.2)
    U0 = jnp.asarray(rng.normal(size=(N - 1, 6)) * 1.0)
    goals = jnp.asarray(rng.normal(size=(N, 3)) * 0.3)
    blocks = kkt.build_qp_gn(m, cfg, X0, U0, goals, dt)
    blocks_reg = blocks._replace(Q=blocks.Q + reg * jnp.eye(12))
    xs = jnp.asarray(rng.normal(size=12) * 0.1)
    # jitted (and persistently cached): eager dispatch of the f64 sweeps
    # costs ~30 s on this box (quick-lane budget, VERDICT r4 #6).
    ric = jax.jit(lambda b, x: riccati.solve(b, x, 1e-6))(blocks_reg, xs)
    sol = jax.jit(
        lambda b, x: pcg.solve(
            b, x, 1e-6, primal_reg=reg, tol=1e-13, max_iters=800
        )
    )(blocks, xs)
    np.testing.assert_allclose(np.asarray(sol.X), np.asarray(ric.X),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sol.U), np.asarray(ric.U),
                               rtol=1e-5, atol=1e-6)
    # Solution satisfies the constraints it eliminated.
    np.testing.assert_allclose(np.asarray(sol.X[0]), np.asarray(xs), atol=1e-8)
    for k in range(N - 1):
        lhs = blocks.A[k] @ sol.X[k] + blocks.B[k] @ sol.U[k] + blocks.c[k]
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(sol.X[k + 1]),
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.slow
def test_sqp_with_pcg_backend_matches_riccati(model64, rng):
    """Full SQP solve with the PCG backend: same accepted steps and a
    final merit within the inexact-QP slack of the Riccati backend; the
    per-iteration pcg_stats populate (reference parity,
    gato_controller.py:98-99)."""
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
    cfg_p = SQPConfig(max_iters=2, qp_backend="pcg", pcg_tol=1e-10,
                      pcg_max_iters=500)
    res_r = sqp_mod.solve(m, cost_cfg, cfg_r, dt, xs, goals, X, U)
    res_p = sqp_mod.solve(m, cost_cfg, cfg_p, dt, xs, goals, X, U)

    assert res_p.stats.pcg_iters is not None
    assert int(res_p.stats.pcg_iters[0]) > 0
    assert res_r.stats.pcg_iters is None

    def final_merit(res):
        return float(sqp_mod.merit(
            m, cost_cfg, cfg_r.merit_mu, res.X, res.U, goals, xs, dt
        ))

    mr, mp = final_merit(res_r), final_merit(res_p)
    m0 = float(sqp_mod.merit(m, cost_cfg, cfg_r.merit_mu, X, U, goals, xs, dt))
    assert mp < m0  # PCG backend makes real progress
    # Within 5% of the exact backend (pcg_primal_reg perturbs the QP).
    assert mp <= 1.05 * mr + 1e-9


def test_block_jacobi_preconditioner_accelerates(rng):
    """The block-Jacobi preconditioner must converge well under the dual
    system's conditioning: far fewer iterations than the dual dimension."""
    N, nx, nu = 32, 12, 6
    blocks = random_blocks(rng, N, nx, nu, 1e-6)
    xs = jnp.asarray(rng.normal(size=nx))
    sol = pcg.solve(blocks, xs, 1e-6, primal_reg=0.0, tol=1e-10,
                    max_iters=N * nx)
    assert int(sol.iterations) < N * nx / 2
    # Exit criterion is relative to |gamma|; check it actually held.
    D, Uo, g_dyn, W, V, Wq, Vr = pcg.build_schur(blocks, 1e-6, 0.0)
    gamma = jnp.concatenate([-(xs + Wq[0])[None], g_dyn], axis=0)
    assert float(sol.residual) <= 1.01e-10 * max(
        1.0, float(jnp.linalg.norm(gamma))
    )
