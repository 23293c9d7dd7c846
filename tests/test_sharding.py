"""Multi-device sharding tests on the virtual 8-device CPU mesh.

Generalizes the reference's single-GPU batch consistency checks
(gato_mpc_batch.py:124-134) to a sharded mesh: lane-sharded solves must
agree with single-device solves bit-for-bit modulo float reassociation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import CostConfig, SampleConfig, SQPConfig
from indy7_mpc.dynamics import ee_pos
from indy7_mpc.mpc.sampled import init_wrench_batch, sampled_tick
from indy7_mpc.parallel import (
    make_lane_mesh,
    make_sharded_batch_solve,
    make_sharded_sampled_tick,
    shard_lanes,
)
from indy7_mpc.solvers import sqp as sqp_mod


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def _problem(model, B, N=8, dt=0.01):
    x0 = jnp.zeros(12, jnp.float64)
    ee0 = ee_pos(model, x0[:6])
    goals = jnp.tile(ee0 + jnp.asarray([0.05, -0.05, 0.04]), (N, 1))
    X = jnp.zeros((N, 12), jnp.float64).at[0].set(x0)
    U = jnp.zeros((N - 1, 6), jnp.float64)
    key = jax.random.PRNGKey(0)
    w = init_wrench_batch(key, SampleConfig(batch_size=B, f_ext_std=8.0),
                          jnp.float64)
    return (
        jnp.tile(x0, (B, 1)),
        jnp.tile(goals, (B, 1, 1)),
        jnp.tile(X, (B, 1, 1)),
        jnp.tile(U, (B, 1, 1)),
        w,
    )


@pytest.mark.slow
def test_sharded_batch_solve_matches_local(model64):
    m = model64
    cost_cfg, sqp_cfg = CostConfig(), SQPConfig(max_iters=2)
    dt = 0.01
    B = 16
    xs, goals, X, U, w = _problem(m, B)

    local = sqp_mod.batch_solve(
        m, cost_cfg, sqp_cfg, dt, xs, goals, X, U, wrench_world_batch=w
    )

    mesh = make_lane_mesh()
    solve = make_sharded_batch_solve(m, cost_cfg, sqp_cfg, dt, mesh)
    args = shard_lanes(mesh, (xs, goals, X, U, w))
    sharded = solve(*args)

    np.testing.assert_allclose(
        np.asarray(sharded.X), np.asarray(local.X), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(sharded.U), np.asarray(local.U), rtol=1e-8, atol=1e-10
    )
    # The result really is distributed across all 8 devices.
    assert len(sharded.X.sharding.device_set) == 8


@pytest.mark.slow
def test_sharded_sampled_tick_matches_local(model64):
    m = model64
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=2)
    sample_cfg = SampleConfig(batch_size=8, f_ext_std=8.0,
                              f_ext_resample_std=0.5)
    dt = 0.01
    x0 = jnp.zeros(12, jnp.float64)
    ee0 = ee_pos(m, x0[:6])
    goals = jnp.tile(ee0, (8, 1))
    X = jnp.zeros((8, 12), jnp.float64).at[0].set(x0)
    U = jnp.zeros((7, 6), jnp.float64)
    key = jax.random.PRNGKey(3)
    f_batch = init_wrench_batch(key, sample_cfg, jnp.float64)
    u_last = jnp.zeros(6, jnp.float64)

    local = sampled_tick(
        m, cost_cfg, sqp_cfg, sample_cfg, dt, key, x0, x0, u_last, goals,
        X, U, f_batch,
    )

    mesh = make_lane_mesh()
    tick = make_sharded_sampled_tick(
        m, cost_cfg, sqp_cfg, sample_cfg, dt, mesh
    )
    sharded = tick(
        key, x0, x0, u_last, goals, X, U, shard_lanes(mesh, f_batch)
    )

    assert int(sharded.best_idx) == int(local.best_idx)
    np.testing.assert_allclose(
        np.asarray(sharded.u), np.asarray(local.u), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(sharded.f_batch), np.asarray(local.f_batch),
        rtol=1e-8, atol=1e-10,
    )


def test_sharded_tick_feedback_edge_stays_lane_sharded(model64):
    """The resampled f_batch must come back lane-sharded so it can feed
    the next tick's in_shardings directly (regression: XLA emitted it
    replicated, breaking the tick->tick feedback edge in multi-process
    runs)."""
    from jax.sharding import PartitionSpec as P

    m = model64
    cost_cfg = CostConfig()
    sqp_cfg = SQPConfig(max_iters=1)
    sample_cfg = SampleConfig(batch_size=8, f_ext_std=8.0,
                              f_ext_resample_std=0.5)
    dt = 0.01
    x0 = jnp.zeros(12, jnp.float64)
    goals = jnp.tile(ee_pos(m, x0[:6]), (4, 1))
    X = jnp.zeros((4, 12), jnp.float64)
    U = jnp.zeros((3, 6), jnp.float64)
    key = jax.random.PRNGKey(3)
    f_batch = init_wrench_batch(key, sample_cfg, jnp.float64)
    u_last = jnp.zeros(6, jnp.float64)

    mesh = make_lane_mesh()
    tick = make_sharded_sampled_tick(
        m, cost_cfg, sqp_cfg, sample_cfg, dt, mesh
    )
    out = tick(key, x0, x0, u_last, goals, X, U, shard_lanes(mesh, f_batch))
    spec = out.f_batch.sharding.spec
    assert spec == P("lanes"), spec
    # And the feedback edge accepts it without resharding errors.
    out2 = tick(key, x0, x0, u_last, goals, X, U, out.f_batch)
    assert np.all(np.isfinite(np.asarray(out2.u)))


@pytest.mark.slow
def test_sharded_closed_loop_matches_single_device(model64):
    """The lane-sharded closed loop (make_sharded_sampled_loop) must
    reproduce run_sampled_mpc exactly (same seeds, same tick program —
    mpc/sampled.py make_loop_tick is shared)."""
    from indy7_mpc.config import MPCConfig
    from indy7_mpc.mpc.sampled import init_loop_carry, run_sampled_mpc
    from indy7_mpc.parallel import make_sharded_sampled_loop

    m = model64
    mpc_cfg = MPCConfig(N=6, dt=0.01)
    sample_cfg = SampleConfig(batch_size=8, f_ext_std=5.0)
    cost_cfg, sqp_cfg = CostConfig(), SQPConfig(max_iters=1)
    steps = 4
    x0 = jnp.zeros(12, jnp.float64)
    hold = ee_pos(m, x0[:6])
    ref = jnp.tile(hold, (steps + mpc_cfg.N + 1, 1))
    f_true = jnp.asarray([4.0, 0.0, -6.0, 0, 0, 0], jnp.float64)
    key = jax.random.PRNGKey(7)

    _, tr_ref = run_sampled_mpc(
        m, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, x0, ref, steps,
        f_true0=f_true, key=key,
    )

    mesh = make_lane_mesh()
    loop, shardings = make_sharded_sampled_loop(
        m, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, mesh, ref, chunk=steps
    )
    c0 = jax.device_put(
        init_loop_carry(m, mpc_cfg, sample_cfg, x0, f_true, key), shardings
    )
    c1, tr_sh = loop(c0)

    np.testing.assert_allclose(
        np.asarray(tr_sh.tracking_error), np.asarray(tr_ref.tracking_error),
        rtol=1e-9, atol=1e-11,
    )
    np.testing.assert_allclose(
        np.asarray(tr_sh.u), np.asarray(tr_ref.u), rtol=1e-8, atol=1e-10
    )
    np.testing.assert_array_equal(
        np.asarray(tr_sh.best_idx), np.asarray(tr_ref.best_idx)
    )


@pytest.mark.slow
def test_32k_lane_sweep_on_virtual_mesh(model32):
    """BASELINE.json's 32k-scenario config as a correctness sweep: a
    32,768-lane sampled-MPC closed loop sharded over the 8-device mesh
    (4,096 lanes per device) runs, stays finite, keeps the hypothesis
    batch lane-sharded across ticks, and picks a consensus lane whose
    wrench estimate is sane."""
    from indy7_mpc.config import MPCConfig
    from indy7_mpc.mpc.sampled import init_loop_carry
    from indy7_mpc.parallel import LANE_AXIS, make_sharded_sampled_loop

    m = model32
    B = 32768
    mpc_cfg = MPCConfig(N=4, dt=0.01)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=10.0,
                              f_ext_resample_std=0.5)
    steps = 2
    x0 = jnp.zeros(12, jnp.float32)
    hold = ee_pos(m, x0[:6])
    ref = jnp.tile(hold, (steps + mpc_cfg.N + 1, 1)).astype(jnp.float32)
    f_true = jnp.asarray([8.0, 0.0, -12.0, 0, 0, 0], jnp.float32)

    mesh = make_lane_mesh()
    loop, shardings = make_sharded_sampled_loop(
        m, CostConfig(), SQPConfig(max_iters=1), mpc_cfg, sample_cfg, mesh,
        ref, chunk=1,
    )
    c0 = jax.device_put(
        init_loop_carry(m, mpc_cfg, sample_cfg, x0, f_true,
                        jax.random.PRNGKey(11)),
        shardings,
    )
    carry = c0
    for _ in range(steps):
        carry, trace = loop(carry)
        assert bool(jnp.all(jnp.isfinite(trace.u)))
        assert bool(jnp.all(jnp.isfinite(trace.tracking_error)))
    # Hypothesis batch still lane-sharded on the feedback edge.
    spec = carry.f_batch.sharding.spec
    assert len(spec) >= 1 and spec[0] == LANE_AXIS, spec
    assert carry.f_batch.shape == (B, 6)
    best = int(np.asarray(trace.best_idx)[-1])
    assert 0 <= best < B
    # The winning hypothesis is bounded by the sampling distribution.
    assert float(jnp.max(jnp.abs(carry.f_batch))) < 10.0 * 6
