"""Horizon-parallel (associative-scan) Riccati vs the sequential sweep.

ops/riccati_pscan.py recasts the backward recursion as a parallel scan
(O(log N) depth) — the batched answer to "sequence parallelism" over the
horizon (SURVEY.md section 5.7).  It must solve the identical QP.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import CostConfig
from indy7_mpc.ops import kkt, riccati, riccati_pscan

from test_riccati import random_blocks


@pytest.mark.parametrize("N,nx,nu", [
    # quick lane: the odd-shape edge case + the production horizon;
    # intermediate horizons ride the slow lane (each parametrization is
    # a separate f64 trace+compile on the 2-core rig).
    (5, 4, 2), (64, 12, 6),
    pytest.param(8, 12, 6, marks=pytest.mark.slow),
    pytest.param(32, 12, 6, marks=pytest.mark.slow),
])
def test_pscan_matches_sequential(rng, N, nx, nu):
    rho = 1e-6
    blocks = random_blocks(rng, N, nx, nu, rho)
    xs = jnp.asarray(rng.normal(size=nx))
    seq = riccati.solve(blocks, xs, rho)
    par = riccati_pscan.solve_pscan(blocks, xs, rho)
    np.testing.assert_allclose(np.asarray(par.X), np.asarray(seq.X),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(par.U), np.asarray(seq.U),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(par.K), np.asarray(seq.K),
                               rtol=1e-6, atol=1e-7)


def test_pscan_real_robot_blocks(model64, rng):
    cfg = CostConfig()
    N, dt = 16, 0.01
    m = model64
    X0 = jnp.asarray(rng.normal(size=(N, 12)) * 0.2)
    U0 = jnp.asarray(rng.normal(size=(N - 1, 6)) * 1.0)
    goals = jnp.asarray(rng.normal(size=(N, 3)) * 0.3)
    blocks = kkt.build_qp_gn(m, cfg, X0, U0, goals, dt)
    xs = jnp.asarray(rng.normal(size=12) * 0.1)
    seq = riccati.solve(blocks, xs, 1e-6)
    par = riccati_pscan.solve_pscan(blocks, xs, 1e-6)
    np.testing.assert_allclose(np.asarray(par.X), np.asarray(seq.X),
                               rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(np.asarray(par.U), np.asarray(seq.U),
                               rtol=1e-6, atol=1e-7)


def test_pscan_batched_lanes_jit(rng):
    N, nx, nu, B = 8, 12, 6, 3
    rho = 1e-6
    all_blocks = [random_blocks(rng, N, nx, nu, rho) for _ in range(B)]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), *all_blocks)
    xs = jnp.asarray(rng.normal(size=(B, nx)))
    vsolve = jax.jit(jax.vmap(riccati_pscan.solve_pscan,
                              in_axes=(0, 0, None)))
    par = vsolve(stacked, xs, rho)
    for i in range(B):
        seq = riccati.solve(all_blocks[i], xs[i], rho)
        np.testing.assert_allclose(np.asarray(par.X[i]), np.asarray(seq.X),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.slow
def test_sqp_pscan_backend_matches_riccati_backend(model64, rng):
    """The SQP outer loop must be backend-invariant between the sequential
    and parallel-scan exact solvers (identical QP, f64)."""
    from indy7_mpc.config import SQPConfig
    from indy7_mpc.solvers import sqp as sqp_mod

    m = model64
    N, dt = 8, 0.01
    cost_cfg = CostConfig()
    goals = jnp.tile(jnp.asarray([0.3, 0.2, 0.6]), (N, 1))
    xs = jnp.asarray(rng.normal(size=12) * 0.1)
    X = jnp.tile(xs, (N, 1))
    U = jnp.zeros((N - 1, 6))

    res_a = sqp_mod.solve(m, cost_cfg, SQPConfig(max_iters=2),
                          dt, xs, goals, X, U)
    res_b = sqp_mod.solve(
        m, cost_cfg, SQPConfig(max_iters=2, qp_backend="riccati_pscan"),
        dt, xs, goals, X, U,
    )
    np.testing.assert_allclose(np.asarray(res_b.X), np.asarray(res_a.X),
                               rtol=1e-8, atol=1e-9)
    np.testing.assert_allclose(np.asarray(res_b.U), np.asarray(res_a.U),
                               rtol=1e-8, atol=1e-8)
