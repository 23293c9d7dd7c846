"""The GPU production solver vs the float64 dense-KKT oracle, on the GPU.

The solver solvers/select.py picks for a GPU runs in float32 on the card;
on the CPU these tests skip (the same solver's CPU parity tests are in
tests/test_lane_sqp.py).  Run them on a GPU machine with:
    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
Each lane is checked by replaying the solver's own accepted-alpha log
through the float64 CPU oracle (solvers/replay.py); the tolerance is on
X and U scaled by their magnitude (float32 on the card vs float64).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.solvers.replay import lane_error, replay_lane

pytestmark = pytest.mark.gpu

TOL = 2e-3


def _problem(rng, B, N, x_scale=0.05, u_scale=0.5, wrench=True):
    xs_b = jnp.asarray(rng.normal(size=(B, 12)) * x_scale, jnp.float32)
    goals_b = jnp.asarray(rng.normal(size=(B, N, 3)) * 0.3, jnp.float32)
    X_b = jnp.asarray(rng.normal(size=(B, N, 12)) * x_scale, jnp.float32)
    U_b = jnp.asarray(rng.normal(size=(B, N - 1, 6)) * u_scale, jnp.float32)
    w_b = None
    if wrench:
        w_b = jnp.asarray(rng.normal(size=(B, 6)) * 8, jnp.float32)
        w_b = w_b.at[:, 3:].set(0.0)
    return xs_b, goals_b, X_b, U_b, w_b


def _assert_lane_matches(res, lane, X_exp, U_exp, atol=TOL):
    assert lane_error(res.X[lane], res.U[lane], X_exp, U_exp) < atol


def test_solver_matches_oracle():
    """Original single-iteration cold-start config (N=8)."""
    from indy7_mpc.config import CostConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.solvers.select import default_batch_solve_fn

    m = indy7(dtype=jnp.float32)
    cost = CostConfig()
    scfg = SQPConfig(max_iters=1)
    N, dt, B = 8, 0.01, 128
    rng = np.random.default_rng(5)
    xs_b, goals_b, X_b, U_b, w_b = _problem(rng, B, N)

    res = jax.jit(default_batch_solve_fn(m, cost, scfg, dt))(
        xs_b, goals_b, X_b, U_b, w_b
    )

    for lane in range(0, B, 17):
        X_exp, U_exp, _ = replay_lane(
            m, cost, scfg, dt, xs_b[lane], goals_b[lane], X_b[lane],
            U_b[lane], w_b[lane], np.asarray(res.stats.alphas[lane]),
            scfg.rho,
        )
        _assert_lane_matches(res, lane, X_exp, U_exp)


@pytest.mark.parametrize("N,wrench", [(32, True), (64, True), (64, False)])
def test_solver_production_config_multi_iter(N, wrench):
    """The configs the framework ships with: max_iters=2 at N=32 and N=64,
    wrench-on and wrench-free, replayed against the CPU oracle per the
    solver's accepted alpha sequence."""
    from indy7_mpc.config import CostConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.solvers.select import default_batch_solve_fn

    m = indy7(dtype=jnp.float32)
    cost = CostConfig()
    scfg = SQPConfig(max_iters=2)
    dt, B = 0.01, 128
    rng = np.random.default_rng(11)
    xs_b, goals_b, X_b, U_b, w_b = _problem(rng, B, N, wrench=wrench)

    res = jax.jit(default_batch_solve_fn(m, cost, scfg, dt))(
        xs_b, goals_b, X_b, U_b, w_b
    )

    assert np.all(np.isfinite(np.asarray(res.X)))
    for lane in range(0, B, 31):
        X_exp, U_exp, rho_exp = replay_lane(
            m, cost, scfg, dt, xs_b[lane], goals_b[lane],
            X_b[lane], U_b[lane],
            None if w_b is None else w_b[lane],
            np.asarray(res.stats.alphas[lane]), scfg.rho,
        )
        _assert_lane_matches(res, lane, X_exp, U_exp)
        np.testing.assert_allclose(
            float(res.state.rho[lane]), rho_exp, rtol=1e-5
        )


def test_solver_rejection_escalates_rho():
    """Lanes engineered to reject QP steps (absurd warm starts far from
    the linearization's validity region): every rejected iteration must
    escalate the lane's Levenberg rho by rho_factor (clipped), and the
    trajectory must stay at the warm start for rejected iterations —
    the done/rejected masking (solvers/sqp_lane.accept_step)."""
    from indy7_mpc.config import CostConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.solvers.select import default_batch_solve_fn

    m = indy7(dtype=jnp.float32)
    # Barrier off: the engineered warm starts sit ~150 rad outside the
    # joint range, where the barrier dominates the merit (~1e8) and f32
    # alpha ties flip against the f64 oracle.  This test exercises the
    # rejection/rho machinery, which is barrier-independent.
    cost = CostConfig(q_barrier=0.0)
    scfg = SQPConfig(max_iters=2)
    N, dt, B = 32, 0.01, 128
    rng = np.random.default_rng(3)
    # Per-lane severity ramp: warm starts grow from mild to absurd
    # (torques up to ~200x the actuator limits, velocities to ~100 rad/s),
    # so one batch covers accept / reject-then-accept / always-reject.
    # For the extreme lanes the QP delta is so large that even the 1/128
    # candidate lands far outside the linearization's validity and the
    # merit increases at every alpha — a genuine full rejection.
    xs_b, goals_b, X_b, U_b, w_b = _problem(
        rng, B, N, x_scale=1.0, u_scale=100.0
    )
    ramp = jnp.linspace(1.0, 160.0, B)
    X_b = X_b * ramp[:, None, None]
    U_b = U_b * ramp[:, None, None]
    xs_b = xs_b * ramp[:, None]

    res = jax.jit(default_batch_solve_fn(m, cost, scfg, dt))(
        xs_b, goals_b, X_b, U_b, w_b
    )

    alphas = np.asarray(res.stats.alphas)
    rejected_lanes = np.nonzero((alphas == 0.0).any(axis=1))[0]
    # The engineered problem must actually exercise the rejection path.
    assert rejected_lanes.size > 0, "no lane rejected — test ineffective"

    for lane in rejected_lanes[::7]:
        X_exp, U_exp, rho_exp = replay_lane(
            m, cost, scfg, dt, xs_b[lane], goals_b[lane],
            X_b[lane], U_b[lane], w_b[lane],
            alphas[lane], scfg.rho,
        )
        np.testing.assert_allclose(
            float(res.state.rho[lane]), rho_exp, rtol=1e-5
        )
        _assert_lane_matches(res, int(lane), X_exp, U_exp)


def test_solver_warm_started_second_solve():
    """Warm-started chained solve (the closed loop's steady state): feed
    the first solve's trajectory and rho state back in and oracle-check
    the second solve too."""
    from indy7_mpc.config import CostConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.solvers.select import default_batch_solve_fn

    m = indy7(dtype=jnp.float32)
    cost = CostConfig()
    scfg = SQPConfig(max_iters=2)
    N, dt, B = 64, 0.01, 128
    rng = np.random.default_rng(17)
    xs_b, goals_b, X_b, U_b, w_b = _problem(rng, B, N)

    from indy7_mpc.solvers import sqp_lane
    from indy7_mpc.solvers.select import use_lane

    assert use_lane(cost, scfg)  # sqp_lane IS the GPU's production solver
    solve = jax.jit(
        lambda xs, g, X, U, w, st: sqp_lane.batch_solve(
            m, cost, scfg, dt, xs, g, X, U,
            wrench_world_batch=w, state=st,
        )
    )
    res1 = solve(xs_b, goals_b, X_b, U_b, w_b, None)
    res2 = solve(xs_b, goals_b, res1.X, res1.U, w_b, res1.state)

    for lane in range(0, B, 41):
        X_exp, U_exp, rho_exp = replay_lane(
            m, cost, scfg, dt, xs_b[lane], goals_b[lane],
            np.asarray(res1.X[lane]), np.asarray(res1.U[lane]),
            w_b[lane],
            np.asarray(res2.stats.alphas[lane]),
            float(res1.state.rho[lane]),
        )
        _assert_lane_matches(res2, lane, X_exp, U_exp)
        np.testing.assert_allclose(
            float(res2.state.rho[lane]), rho_exp, rtol=1e-5
        )


def test_solver_sharded_matches_unsharded():
    """The production solver under the lane mesh (shard_map) must equal
    the plain call: lanes are independent, so per-lane results are the
    same on a mesh of any size (one GPU here: a 1-device mesh)."""
    from indy7_mpc.config import CostConfig, SQPConfig
    from indy7_mpc.models import indy7
    from indy7_mpc.parallel import (
        make_lane_mesh, make_sharded_batch_solve, shard_lanes,
    )
    from indy7_mpc.solvers.select import default_batch_solve_fn

    m = indy7(dtype=jnp.float32)
    cost = CostConfig()
    scfg = SQPConfig(max_iters=2)
    N, dt, B = 32, 0.01, 128
    rng = np.random.default_rng(23)
    xs_b, goals_b, X_b, U_b, w_b = _problem(rng, B, N)

    plain = jax.jit(default_batch_solve_fn(m, cost, scfg, dt))(
        xs_b, goals_b, X_b, U_b, w_b
    )

    mesh = make_lane_mesh()
    solve = make_sharded_batch_solve(m, cost, scfg, dt, mesh)
    args = shard_lanes(mesh, (xs_b, goals_b, X_b, U_b, w_b))
    sharded = solve(*args)

    np.testing.assert_allclose(
        np.asarray(sharded.X), np.asarray(plain.X), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(sharded.U), np.asarray(plain.U), atol=1e-5
    )
    assert len(sharded.X.sharding.device_set) == len(mesh.devices.flat)
