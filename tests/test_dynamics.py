"""Dynamics-layer oracle tests (SURVEY.md section 4 test pyramid, level 1).

Oracles, since Pinocchio is unavailable on this image:
  * autodiff (jacfwd) for analytic Jacobians,
  * RNEA <-> forward-dynamics algebraic consistency,
  * CRBA vs unit-acceleration RNEA columns,
  * energy conservation of the unforced system,
  * virtual-work identity for external world wrenches,
  * URDF parser vs embedded Indy7 parameters.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from indy7_mpc.dynamics import (
    crba,
    ee_pos,
    ee_pos_jacobian,
    euler_step,
    forward_dynamics,
    joint_frames,
    rk4_step,
    rnea,
    world_wrench_to_ee_joint,
)
from indy7_mpc.models import INDY7_URDF, indy7, parse_urdf

Q = jnp.array([0.3, -0.5, 0.7, 0.2, -0.4, 0.6])
V = jnp.array([0.1, 0.2, -0.3, 0.05, 0.15, -0.25])
TAU = jnp.array([1.0, -2.0, 0.5, 0.1, -0.3, 0.2])


def test_urdf_parser_matches_embedded_params(model64):
    # The vendored copy of the robot description (self-contained: no
    # dependency on the reference checkout).
    parsed = parse_urdf(INDY7_URDF, dtype=jnp.float64)
    for field in [
        "tree_R", "tree_p", "axis", "mass", "com", "I_com",
        "tcp_offset", "effort_limit", "velocity_limit", "q_lower", "q_upper",
    ]:
        np.testing.assert_allclose(
            np.asarray(getattr(parsed, field)),
            np.asarray(getattr(model64, field)),
            atol=1e-12,
            err_msg=field,
        )


def test_fk_zero_config_geometry(model64):
    # At q=0 the chain's joint origins follow the URDF tree placements.
    R, p = joint_frames(model64, jnp.zeros(6))
    # Joint 0 at [0, 0, 0.0775] (indy7.urdf:201).
    np.testing.assert_allclose(np.asarray(p[0]), [0, 0, 0.0775], atol=1e-12)
    # Joint 1 origin at [0, -0.109, 0.2995] in world.
    np.testing.assert_allclose(
        np.asarray(p[1]), [0.0, -0.109, 0.0775 + 0.222], atol=1e-9
    )
    # All rotations orthonormal.
    RtR = np.einsum("jba,jbc->jac", np.asarray(R), np.asarray(R))
    np.testing.assert_allclose(RtR, np.tile(np.eye(3), (6, 1, 1)), atol=1e-12)


def test_ee_jacobian_matches_autodiff(model64):
    p, J = ee_pos_jacobian(model64, Q)
    Jfd = jax.jacfwd(lambda q: ee_pos(model64, q))(Q)
    np.testing.assert_allclose(np.asarray(J), np.asarray(Jfd), atol=1e-10)
    np.testing.assert_allclose(
        np.asarray(p), np.asarray(ee_pos(model64, Q)), atol=1e-12
    )


def test_forward_dynamics_rnea_roundtrip(model64):
    a = forward_dynamics(model64, Q, V, TAU)
    tau_back = rnea(model64, Q, V, a)
    np.testing.assert_allclose(np.asarray(tau_back), np.asarray(TAU), atol=1e-8)


def test_crba_matches_rnea_columns(model64):
    M = crba(model64, Q)
    cols = [
        rnea(model64, Q, jnp.zeros(6), jnp.eye(6)[i], gravity=False)
        for i in range(6)
    ]
    Mref = np.stack([np.asarray(c) for c in cols], axis=-1)
    np.testing.assert_allclose(np.asarray(M), Mref, atol=1e-10)
    np.testing.assert_allclose(np.asarray(M), np.asarray(M).T, atol=1e-10)
    assert np.all(np.linalg.eigvalsh(np.asarray(M)) > 0)


def test_energy_conservation(model64):
    m = model64

    @jax.jit
    def energy(x):
        q, v = x[:6], x[6:]
        ke = 0.5 * v @ crba(m, q) @ v
        R, p = joint_frames(m, q)
        com_w = p + jnp.einsum("jab,jb->ja", R, m.com)
        pe = -jnp.sum(m.mass * (com_w @ m.gravity))
        return ke + pe

    @jax.jit
    def rollout(x):
        def dyn(x):
            q, v = x[:6], x[6:]
            a = forward_dynamics(m, q, v, jnp.zeros(6))
            return jnp.concatenate([v, a])

        def step(x, _):
            dt = 1e-4
            k1 = dyn(x)
            k2 = dyn(x + dt / 2 * k1)
            k3 = dyn(x + dt / 2 * k2)
            k4 = dyn(x + dt * k3)
            return x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + k4), None

        return jax.lax.scan(step, x, None, length=2000)[0]

    x0 = jnp.concatenate([Q, V])
    drift = float(energy(rollout(x0)) - energy(x0))
    assert abs(drift) < 1e-8, drift


def test_world_wrench_virtual_work(model64):
    """Generalized forces from the world wrench must equal axis . n_about_joint.

    The reference's wrench semantics: zero moment about the *world origin*
    (gato_mpc_batch_sample.py:151-161).
    """
    m = model64
    w = jnp.array([5.0, -3.0, 8.0, 0.7, -0.2, 0.4])
    fl = world_wrench_to_ee_joint(m, Q, w)
    z = jnp.zeros(6)
    f_ext = jnp.zeros((6, 6)).at[-1].set(fl)
    tau_w = rnea(m, Q, z, z, gravity=False) - rnea(
        m, Q, z, z, f_ext=f_ext, gravity=False
    )
    R, p = joint_frames(m, Q)
    expected = []
    for j in range(6):
        axis_w = R[j] @ m.axis[j]
        expected.append(axis_w @ (w[3:] - jnp.cross(p[j], w[:3])))
    np.testing.assert_allclose(
        np.asarray(tau_w), np.asarray(jnp.stack(expected)), atol=1e-9
    )


def test_batching_consistency(model64):
    m = model64
    a = forward_dynamics(m, Q, V, TAU)
    qb, vb, taub = (jnp.tile(z, (4, 1)) for z in (Q, V, TAU))
    ab = forward_dynamics(m, qb, vb, taub)
    assert ab.shape == (4, 6)
    np.testing.assert_allclose(np.asarray(ab), np.tile(np.asarray(a), (4, 1)))

    x = jnp.concatenate([Q, V])
    x1 = euler_step(m, x, TAU, 0.01)
    xb = euler_step(m, jnp.tile(x, (4, 1)), taub, 0.01)
    np.testing.assert_allclose(np.asarray(xb), np.tile(np.asarray(x1), (4, 1)))

    xr = rk4_step(m, x, TAU, 0.01)
    assert xr.shape == (12,)


def test_rk4_converges_to_euler_limit(model64):
    """One rk4 step at dt and 100 euler steps at dt/100 should agree closely."""
    m = model64
    x = jnp.concatenate([Q, V])
    dt = 0.01
    x_rk4 = rk4_step(m, x, TAU, dt)

    @jax.jit
    def euler_fine(x):
        def step(x, _):
            return euler_step(m, x, TAU, dt / 200), None

        return jax.lax.scan(step, x, None, length=200)[0]

    np.testing.assert_allclose(
        np.asarray(x_rk4), np.asarray(euler_fine(x)), atol=5e-4
    )


def test_float32_close_to_float64(model64, model32):
    a64 = forward_dynamics(model64, Q, V, TAU)
    a32 = forward_dynamics(
        model32, Q.astype(jnp.float32), V.astype(jnp.float32),
        TAU.astype(jnp.float32),
    )
    np.testing.assert_allclose(
        np.asarray(a32), np.asarray(a64), rtol=2e-3, atol=2e-3
    )


def test_aba_matches_crba_forward_dynamics(model64):
    """ABA (O(n) articulated-body recursion, the reference's pin.aba) must
    equal the CRBA + Cholesky forward dynamics to machine precision,
    with and without gravity and an EE wrench."""
    from indy7_mpc.dynamics.aba import forward_dynamics_aba
    from indy7_mpc.dynamics.rnea import (
        forward_dynamics,
        world_wrench_to_ee_joint,
    )

    m = model64
    rng = np.random.default_rng(7)
    q = jnp.asarray(rng.normal(size=(5, 6)) * 0.8)
    v = jnp.asarray(rng.normal(size=(5, 6)) * 1.5)
    tau = jnp.asarray(rng.normal(size=(5, 6)) * 30.0)

    a_ref = forward_dynamics(m, q, v, tau)
    a_aba = forward_dynamics_aba(m, q, v, tau)
    np.testing.assert_allclose(np.asarray(a_aba), np.asarray(a_ref),
                               rtol=1e-10, atol=1e-10)

    a_ref = forward_dynamics(m, q, v, tau, gravity=False)
    a_aba = forward_dynamics_aba(m, q, v, tau, gravity=False)
    np.testing.assert_allclose(np.asarray(a_aba), np.asarray(a_ref),
                               rtol=1e-10, atol=1e-10)

    w_world = jnp.asarray([10.0, -15.0, 6.0, 1.0, -2.0, 0.5])
    f_ee = jax.vmap(lambda qi: world_wrench_to_ee_joint(m, qi, w_world))(q)
    a_ref = forward_dynamics(m, q, v, tau, f_ext_ee=f_ee)
    a_aba = forward_dynamics_aba(m, q, v, tau, f_ext_ee=f_ee)
    np.testing.assert_allclose(np.asarray(a_aba), np.asarray(a_ref),
                               rtol=1e-10, atol=1e-10)


def test_aba_jit_and_grad(model64):
    """ABA must trace under jit and differentiate (it feeds linearization)."""
    from indy7_mpc.dynamics.aba import forward_dynamics_aba

    m = model64
    q = jnp.full(6, 0.3)
    v = jnp.full(6, 0.2)
    tau = jnp.full(6, 5.0)
    a = jax.jit(lambda q, v, t: forward_dynamics_aba(m, q, v, t))(q, v, tau)
    assert a.shape == (6,)
    J = jax.jacfwd(lambda qq: forward_dynamics_aba(m, qq, v, tau))(q)
    assert np.all(np.isfinite(np.asarray(J)))
