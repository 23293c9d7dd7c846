"""Model-mismatch (perturbed-plant) validation tests.

The reference validates its controller against a *different* engine
(MuJoCo: own integrator, sensor noise — sim_node.cpp:184-201,
indy7.xml:62-75); these tests give the framework the same property
explicitly: a seeded mismatched plant (inertial error, joint friction,
actuation noise, finer substeps) that the controller must still track on.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.config import (
    CostConfig,
    MPCConfig,
    PERTURBED_PLANT,
    PlantConfig,
    SampleConfig,
    SQPConfig,
)
from indy7_mpc.sim.plant import (
    perturb_model,
    perturbation_scales,
    plant_step,
)

CFG = PlantConfig(
    param_scale_pct=0.04, seed=7, viscous_friction=0.05, coulomb_friction=0.1
)

X0 = np.array(
    [0.3, -0.5, 0.7, 0.2, -0.4, 0.6, 0.1, 0.2, -0.3, 0.05, 0.15, -0.25]
)
U0 = np.array([1.0, -2.0, 0.5, 0.1, -0.3, 0.2])
W0 = np.array([5.0, -3.0, 8.0, 0.0, 0.0, 0.0])


def test_perturbation_scales_deterministic_and_bounded():
    a = perturbation_scales(7, 12)
    b = perturbation_scales(7, 12)
    np.testing.assert_array_equal(a, b)
    assert np.all(np.abs(a) <= 1.0)
    # Different seeds give different robots.
    assert not np.allclose(a, perturbation_scales(8, 12))


def test_perturbed_model_differs_but_stays_physical(model64):
    pm = perturb_model(model64, CFG)
    ratio = np.asarray(pm.mass) / np.asarray(model64.mass)
    assert np.all(np.abs(ratio - 1.0) <= CFG.param_scale_pct + 1e-12)
    assert not np.allclose(ratio, 1.0)
    # Inertia stays symmetric positive-definite after scaling.
    for I in np.asarray(pm.I_com):
        np.testing.assert_allclose(I, I.T, atol=1e-15)
        assert np.all(np.linalg.eigvalsh(I) > 0)


def test_native_perturbed_step_parity(model64, native_build):
    """C++ perturb_model + friction RK4 must match the JAX plant exactly
    (shared splitmix64 draws; same friction law in every stage)."""
    from indy7_mpc.sim import native
    pm = perturb_model(model64, CFG)
    xj = plant_step(
        pm, jnp.asarray(X0), jnp.asarray(U0), 0.01,
        wrench_world=jnp.asarray(W0), clamp_torque=False,
        friction=(CFG.viscous_friction, CFG.coulomb_friction),
        enforce_limits=False,
    )
    xn = native.perturbed_rk4_step(
        X0, U0, 0.01, wrench_world=W0, pct=CFG.param_scale_pct,
        seed=CFG.seed, kv=CFG.viscous_friction, kc=CFG.coulomb_friction,
    )
    np.testing.assert_allclose(np.asarray(xj), xn, atol=1e-12)


def test_friction_dissipates_energy(model64):
    """Unforced pendulum swing: with joint friction the mechanical energy
    must strictly decrease; without it RK4 conserves to ~1e-8."""
    from indy7_mpc.dynamics import crba, joint_frames

    m = model64

    def energy(x):
        q, v = x[:6], x[6:]
        ke = 0.5 * v @ crba(m, q) @ v
        R, p = joint_frames(m, q)
        com_w = p + jnp.einsum("jab,jb->ja", R, m.com)
        pe = -jnp.sum(m.mass * (com_w @ m.gravity))
        return ke + pe

    import jax as _jax

    x = jnp.asarray(X0)
    u = jnp.zeros(6, jnp.float64)
    e0 = float(energy(x))

    @_jax.jit
    def swing(x):
        step = lambda xx, _: (plant_step(m, xx, u, 0.002,
                                         friction=(0.3, 0.5),
                                         clamp_torque=False), None)
        return _jax.lax.scan(step, x, None, length=50)[0]

    ef = float(energy(swing(x)))
    assert ef < e0 - 1e-3


def test_torque_noise_is_zero_mean_and_seeded(model64):
    key = jax.random.PRNGKey(3)
    a = plant_step(model64, jnp.asarray(X0), jnp.asarray(U0), 0.01,
                   torque_noise_std=0.5, key=key)
    b = plant_step(model64, jnp.asarray(X0), jnp.asarray(U0), 0.01,
                   torque_noise_std=0.5, key=key)
    c = plant_step(model64, jnp.asarray(X0), jnp.asarray(U0), 0.01,
                   torque_noise_std=0.5, key=jax.random.PRNGKey(4))
    nom = plant_step(model64, jnp.asarray(X0), jnp.asarray(U0), 0.01)
    small = plant_step(model64, jnp.asarray(X0), jnp.asarray(U0), 0.01,
                       torque_noise_std=0.05, key=key)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert not np.allclose(np.asarray(a), np.asarray(c))
    # The perturbation scales linearly with the noise std (same draws).
    d_big = np.abs(np.asarray(a) - np.asarray(nom)).max()
    d_small = np.abs(np.asarray(small) - np.asarray(nom)).max()
    assert d_small > 0
    np.testing.assert_allclose(d_big / d_small, 10.0, rtol=0.2)


def test_closed_loop_tracks_under_model_mismatch(model32):
    """Station-keeping on the PERTURBED plant: the controller (which only
    knows the nominal model) must still hold the EE near the reference.

    This is the structural property the reference demonstrates by running
    against MuJoCo — tracking under dynamics the solver did not
    linearize."""
    from indy7_mpc.dynamics import ee_pos
    from indy7_mpc.mpc.sampled import run_sampled_mpc

    model = model32
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
        plant_cfg=PERTURBED_PLANT,
    )
    te = np.asarray(trace.tracking_error)
    assert np.all(np.isfinite(te))
    # Settled tracking stays tight despite ~4% inertial error, friction,
    # torque noise, and 5x substeps (bound well under the reference's
    # 0.125 m batch-64 mean under mismatch, BASELINE.md).
    assert te[n_steps // 2 :].mean() < 0.1, te[n_steps // 2 :].mean()
