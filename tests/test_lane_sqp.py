"""Lane-major SQP path (ops/lane_sqp + solvers/sqp_lane) vs the readable
oracle (ops/kkt + ops/riccati + solvers/sqp).

The lane-major engine is the GPU production solver; this pins it to the
generic layer:
  * QP block construction matches build_qp_gn per lane;
  * the unrolled Riccati sweep matches ops/riccati.solve;
  * the full batched solve matches solvers/sqp.batch_solve, including
    line-search alpha choices and rho evolution.
In f64 agreement is ~1e-12; f32 checks the two float32 paths stay within
solver noise of each other.
"""
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.slow  # f64 parity sweep: heavy CPU compiles (see pytest.ini)

from indy7_mpc.config import CostConfig, SQPConfig
from indy7_mpc.models import indy7
from indy7_mpc.ops import kkt, lane_rbd as LR, lane_sqp as LS, riccati
from indy7_mpc.solvers import sqp as sqp_ref
from indy7_mpc.solvers import sqp_lane


def _problem(dtype, B=6, N=8, seed=5):
    rng = np.random.default_rng(seed)
    xs = jnp.asarray(rng.normal(size=(B, 12)) * 0.05, dtype)
    goals = jnp.asarray(rng.normal(size=(B, N, 3)) * 0.3, dtype)
    X = jnp.asarray(rng.normal(size=(B, N, 12)) * 0.05, dtype)
    X = X.at[:, 0].set(xs)
    U = jnp.asarray(rng.normal(size=(B, N - 1, 6)) * 0.5, dtype)
    w = jnp.asarray(rng.normal(size=(B, 6)) * 8, dtype)
    w = w.at[:, 3:].set(0.0)
    return xs, goals, X, U, w


def test_blocks_and_riccati_match_oracle_f64(model64):
    dtype = jnp.float64
    cost = CostConfig()
    scfg = SQPConfig(max_iters=1)
    dt, B = 0.01, 6
    xs, goals, X, U, w = _problem(dtype, B=B)
    sm = LR.static_model(model64)

    bl = LS.build_blocks(
        sm, cost,
        jnp.transpose(X, (1, 2, 0)), jnp.transpose(U, (1, 2, 0)),
        jnp.transpose(goals, (1, 2, 0)), dt, wrench=w.T,
    )
    dXl, dUl = LS.riccati(
        bl, jnp.zeros((12, B), dtype), jnp.full((B,), scfg.rho, dtype)
    )
    dXl = np.asarray(jnp.transpose(dXl, (2, 0, 1)))
    dUl = np.asarray(jnp.transpose(dUl, (2, 0, 1)))

    for lane in range(B):
        blocks = kkt.build_qp_gn(
            model64, cost, X[lane], U[lane], goals[lane], dt,
            wrench_world=w[lane],
        )
        np.testing.assert_allclose(
            np.asarray(bl.A[..., lane]), np.asarray(blocks.A), atol=1e-11
        )
        np.testing.assert_allclose(
            np.asarray(bl.Bm[..., lane]), np.asarray(blocks.B), atol=1e-12
        )
        np.testing.assert_allclose(
            np.asarray(bl.Q[..., lane]), np.asarray(blocks.Q), atol=1e-11
        )
        sol = riccati.solve(blocks, jnp.zeros(12, dtype), scfg.rho)
        np.testing.assert_allclose(dUl[lane], np.asarray(sol.U), atol=1e-9)
        np.testing.assert_allclose(dXl[lane], np.asarray(sol.X), atol=1e-10)


@pytest.mark.parametrize("dtype,atol", [(jnp.float64, 1e-9), (jnp.float32, 3e-3)])
def test_lane_solver_matches_generic(dtype, atol, model64, model32):
    model = model64 if dtype == jnp.float64 else model32
    cost = CostConfig()
    scfg = SQPConfig(max_iters=2)
    dt = 0.01
    xs, goals, X, U, w = _problem(dtype, B=4, N=8, seed=7)

    res_l = sqp_lane.batch_solve(
        model, cost, scfg, dt, xs, goals, X, U, wrench_world_batch=w
    )
    res_g = sqp_ref.batch_solve(
        model, cost, scfg, dt, xs, goals, X, U, wrench_world_batch=w
    )
    # Line-search decisions must agree lane-by-lane (discrete, so exact)...
    np.testing.assert_array_equal(
        np.asarray(res_l.stats.alphas), np.asarray(res_g.stats.alphas)
    )
    np.testing.assert_array_equal(
        np.asarray(res_l.state.rho), np.asarray(res_g.state.rho)
    )
    # ...and the accepted trajectories to tolerance.
    np.testing.assert_allclose(
        np.asarray(res_l.U), np.asarray(res_g.U), atol=atol
    )
    np.testing.assert_allclose(
        np.asarray(res_l.X), np.asarray(res_g.X), atol=atol
    )
