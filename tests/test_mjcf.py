"""MJCF model parser: parity with the URDF description + plant role.

The reference's controller and simulator consume two independent
descriptions of the same robot (URDF via Pinocchio, MJCF via MuJoCo —
src/utils.py:20-21 vs sim_node.cpp:184-201).  These tests pin that the
framework's MJCF parser reconstructs the same physical robot as the
URDF path (kinematics exactly, inertials to the MJCF file's printed
precision) and that a closed loop with a URDF controller against an
MJCF-built plant still tracks — real model-source mismatch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.models import indy7_mjcf, INDY7_MJCF, mjcf_meta


@pytest.fixture(scope="module")
def mj64():
    return indy7_mjcf(dtype=jnp.float64)


def test_mjcf_parses_chain_and_limits(mj64):
    m = mj64
    assert m.nj == 6
    # Effort limits come from the actuator ctrlrange (indy7.xml:52-59)
    # and must equal the URDF's per-joint torque limits.
    np.testing.assert_allclose(
        np.asarray(m.effort_limit),
        [431.97, 431.97, 197.23, 79.79, 79.79, 79.79],
    )
    np.testing.assert_allclose(
        np.asarray(m.q_upper)[:5], [3.05433] * 5, atol=1e-5
    )
    np.testing.assert_allclose(float(m.q_upper[5]), 3.75246, atol=1e-5)
    # All joints are z-hinges in the MJCF.
    np.testing.assert_allclose(np.asarray(m.axis), [[0, 0, 1]] * 6)


def test_mjcf_kinematics_match_urdf(model64, mj64):
    """FK through the MJCF body tree must reproduce the URDF chain to the
    file's quaternion precision (6 printed digits -> ~1e-6 rad)."""
    from indy7_mpc.dynamics import ee_pos, joint_frames

    rng = np.random.default_rng(2)
    for _ in range(5):
        q = jnp.asarray(rng.uniform(-2.5, 2.5, 6))
        _, p_u = joint_frames(model64, q)
        _, p_m = joint_frames(mj64, q)
        np.testing.assert_allclose(
            np.asarray(p_m), np.asarray(p_u), atol=2e-5
        )
        np.testing.assert_allclose(
            np.asarray(ee_pos(mj64, q)), np.asarray(ee_pos(model64, q)),
            atol=2e-5,
        )


def test_mjcf_inertials_match_urdf(model64, mj64):
    """The MJCF stores principal-axis inertias (quat + diaginertia);
    rotating them back must give the URDF's full inertia tensors."""
    np.testing.assert_allclose(
        np.asarray(mj64.mass), np.asarray(model64.mass), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(mj64.com), np.asarray(model64.com), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(mj64.I_com), np.asarray(model64.I_com), atol=2e-5
    )


def test_mjcf_dynamics_match_urdf(model64, mj64):
    """Forward dynamics through either description agree (same robot)."""
    from indy7_mpc.dynamics import forward_dynamics

    rng = np.random.default_rng(4)
    q = jnp.asarray(rng.normal(size=6) * 0.7)
    v = jnp.asarray(rng.normal(size=6))
    tau = jnp.asarray(rng.normal(size=6) * 10)
    a_u = forward_dynamics(model64, q, v, tau)
    a_m = forward_dynamics(mj64, q, v, tau)
    np.testing.assert_allclose(
        np.asarray(a_m), np.asarray(a_u), rtol=2e-4, atol=2e-4
    )


def test_mjcf_meta_sensor_noise():
    meta = mjcf_meta(INDY7_MJCF)
    noise = meta["actuatorfrc_noise"]
    assert len(noise) == 6
    assert all(v == 0.001 for v in noise.values())


@pytest.mark.slow
def test_closed_loop_urdf_controller_mjcf_plant(model32):
    """Controller on the URDF model, plant on the MJCF model — the
    reference's exact model-source split — must still hold station."""
    from indy7_mpc.config import (
        CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc.dynamics import ee_pos
    from indy7_mpc.mpc.sampled import run_sampled_mpc

    model = model32
    plant = indy7_mjcf(dtype=jnp.float32)
    n_steps = 120
    mpc_cfg = MPCConfig(N=8, dt=0.01)
    x0 = jnp.zeros(12, jnp.float32)
    hold = ee_pos(model, x0[:6])
    ref = jnp.tile(hold, (n_steps + mpc_cfg.N + 1, 1))

    _, trace = run_sampled_mpc(
        model, CostConfig(), SQPConfig(max_iters=1), mpc_cfg,
        SampleConfig(batch_size=4, f_ext_std=3.0, f_ext_resample_std=0.5),
        x0, ref, n_steps,
        f_true0=jnp.asarray([3.0, 0.0, -5.0, 0, 0, 0], jnp.float32),
        key=jax.random.PRNGKey(0),
        plant_model=plant,
    )
    te = np.asarray(trace.tracking_error)
    assert np.all(np.isfinite(te))
    assert te[n_steps // 2:].mean() < 0.1, te[n_steps // 2:].mean()
