"""Riccati QP solver vs a dense KKT oracle (SURVEY.md section 7 phase 4).

The oracle assembles the full equality-constrained QP
    min 0.5 z^T P z + g^T z   s.t.  G z = h
densely in numpy (the role OSQP plays for the reference,
osqp_solver.py:137-143) and solves the KKT system directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import CostConfig
from indy7_mpc.ops import kkt, riccati


def random_blocks(rng, N, nx, nu, rho, dtype=np.float64):
    """Random well-posed QP blocks mimicking the MPC structure."""
    A = rng.normal(size=(N - 1, nx, nx)) * 0.3 + np.eye(nx)
    B = rng.normal(size=(N - 1, nx, nu)) * 0.2
    c = rng.normal(size=(N - 1, nx)) * 0.1
    # PSD rank-1 position-style Hessians + small diagonal, like the GN cost.
    w = rng.normal(size=(N, nx))
    Q = np.einsum("ki,kj->kij", w, w) + 1e-3 * np.eye(nx)
    q = rng.normal(size=(N, nx))
    R = np.tile(1e-4 * np.eye(nu), (N - 1, 1, 1))
    r = rng.normal(size=(N - 1, nu)) * 1e-3
    return kkt.QPBlocks(
        A=jnp.asarray(A, dtype), B=jnp.asarray(B, dtype), c=jnp.asarray(c, dtype),
        Q=jnp.asarray(Q, dtype), q=jnp.asarray(q, dtype),
        R=jnp.asarray(R, dtype), r=jnp.asarray(r, dtype),
    )


def dense_solve(blocks, xs, rho):
    """Dense KKT oracle (the package's numpy reference solver)."""
    from indy7_mpc.ops import dense_kkt

    return dense_kkt.solve(blocks, xs, rho)


@pytest.mark.parametrize("N,nx,nu", [(8, 12, 6), (32, 12, 6), (5, 4, 2)])
def test_riccati_matches_dense_kkt(rng, N, nx, nu):
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    sol = jax.jit(riccati.solve)(blocks, xs, rho)
    Xd, Ud = dense_solve(blocks, np.asarray(xs), rho)
    np.testing.assert_allclose(np.asarray(sol.X), Xd, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(sol.U), Ud, rtol=1e-6, atol=1e-7)


def test_riccati_batched_lanes(rng):
    N, nx, nu, B_lanes = 8, 12, 6, 4
    rho = 1e-6
    all_blocks = [random_blocks(rng, N, nx, nu, rho) for _ in range(B_lanes)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *all_blocks)
    xs = jnp.asarray(rng.normal(size=(B_lanes, nx)))
    vsolve = jax.jit(jax.vmap(riccati.solve, in_axes=(0, 0, None)))
    sol = vsolve(stacked, xs, rho)
    for i in range(B_lanes):
        Xd, Ud = dense_solve(all_blocks[i], np.asarray(xs[i]), rho)
        np.testing.assert_allclose(np.asarray(sol.X[i]), Xd, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(np.asarray(sol.U[i]), Ud, rtol=1e-6, atol=1e-7)


def test_mpc_qp_blocks_satisfy_constraints(model64, rng):
    """End-to-end: blocks from the real robot linearization, Riccati output
    must satisfy the linearized dynamics and pinned initial state."""
    cfg = CostConfig()
    N = 16
    dt = 0.01
    m = model64
    X0 = jnp.asarray(rng.normal(size=(N, 12)) * 0.2)
    U0 = jnp.asarray(rng.normal(size=(N - 1, 6)) * 1.0)
    goals = jnp.asarray(rng.normal(size=(N, 3)) * 0.3)
    blocks = kkt.build_qp(m, cfg, X0, U0, goals, dt)
    xs = jnp.asarray(rng.normal(size=12) * 0.1)
    sol = riccati.solve(blocks, xs, 1e-6)
    np.testing.assert_allclose(np.asarray(sol.X[0]), np.asarray(xs), atol=1e-10)
    for k in range(N - 1):
        lhs = blocks.A[k] @ sol.X[k] + blocks.B[k] @ sol.U[k] + blocks.c[k]
        np.testing.assert_allclose(
            np.asarray(lhs), np.asarray(sol.X[k + 1]), rtol=1e-6, atol=1e-8
        )
    # And it must agree with the dense oracle on the real-robot blocks.
    Xd, Ud = dense_solve(blocks, np.asarray(xs), 1e-6)
    np.testing.assert_allclose(np.asarray(sol.X), Xd, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sol.U), Ud, rtol=1e-4, atol=1e-6)


def test_linearization_matches_finite_difference(model64):
    m = model64
    dt = 0.01
    X = jnp.asarray(np.linspace(0.1, 0.4, 2 * 12).reshape(2, 12))
    U = jnp.asarray(np.full((1, 6), 0.5))
    A, B, c = jax.jit(lambda X, U: kkt.linearize_dynamics(m, X, U, dt))(X, U)
    from indy7_mpc.dynamics import euler_step

    x, u = X[0], U[0]
    eps = 1e-6
    # All 12 central differences in ONE jitted vmap (eager per-direction
    # euler_steps cost ~40 s on this box; quick-lane budget).
    fd_all = jax.jit(
        jax.vmap(
            lambda dx: (
                euler_step(m, x + dx, u, dt) - euler_step(m, x - dx, u, dt)
            ) / (2 * eps)
        )
    )(eps * jnp.eye(12))
    np.testing.assert_allclose(
        np.asarray(A[0]), np.asarray(fd_all).T, atol=1e-5
    )
    # structure: top rows are [I, dt I]
    np.testing.assert_allclose(np.asarray(A[0, :6, :6]), np.eye(6), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(A[0, :6, 6:]), dt * np.eye(6), atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(B[0, :6, :]), np.zeros((6, 6)), atol=1e-12)
