"""Lane-major SoA engine vs the generic dynamics layer (eager, f64).

These run WITHOUT jit: the lane engine's huge unrolled graphs hit XLA:CPU
superlinear compile times, but eager execution at small L is fast and
exact.  The same code is the engine of the lane-major solver
(solvers/sqp_lane.py).
"""
import jax
import jax.numpy as jnp
import numpy as np

from indy7_mpc.dynamics import (
    ee_pos,
    ee_pos_jacobian,
    forward_dynamics,
    world_wrench_to_ee_joint,
)
from indy7_mpc.ops import lane_rbd as LR
from indy7_mpc.sim.plant import plant_step


def _data(rng, L=9):
    q = jnp.asarray(rng.normal(size=(6, L)))
    v = jnp.asarray(rng.normal(size=(6, L)))
    tau = jnp.asarray(rng.normal(size=(6, L)) * 5)
    w = jnp.asarray(rng.normal(size=(6, L)) * 10).at[3:].set(0.0)
    return q, v, tau, w


def test_lane_engine_matches_generic(model64, rng):
    sm = LR.static_model(model64)
    q, v, tau, w = _data(rng)
    qT, vT, tauT, wT = q.T, v.T, tau.T, w.T

    p = jnp.stack(LR.ee_pos(sm, [q[i] for i in range(6)]))
    np.testing.assert_allclose(
        np.asarray(p), np.asarray(ee_pos(model64, qT).T), atol=1e-12
    )

    _, cols = LR.ee_pos_jacobian(sm, [q[i] for i in range(6)])
    J = jnp.stack([jnp.stack(list(c)) for c in cols], axis=1)
    _, Jr = ee_pos_jacobian(model64, qT)
    np.testing.assert_allclose(
        np.asarray(J), np.asarray(jnp.moveaxis(Jr, 0, 2)), atol=1e-12
    )

    fl = world_wrench_to_ee_joint(model64, qT, wT)
    a_ref = forward_dynamics(model64, qT, vT, tauT, f_ext_ee=fl)
    fe = LR.world_wrench_to_ee(
        sm, [q[i] for i in range(6)], [w[i] for i in range(6)]
    )
    a, _ = LR.forward_dynamics(
        sm, [q[i] for i in range(6)], [v[i] for i in range(6)],
        [tau[i] for i in range(6)], f_ext_ee=fe,
    )
    np.testing.assert_allclose(
        np.asarray(jnp.stack(a)), np.asarray(a_ref.T), atol=1e-9
    )

    x = jnp.concatenate([q, v])
    r = LR.rk4_step(sm, x, tau, 0.01, wrench_world=w)
    r_ref = jax.vmap(
        lambda xx, uu, ww: plant_step(model64, xx, uu, 0.01, wrench_world=ww,
                                      enforce_limits=False)
    )(x.T, tauT, wT)
    np.testing.assert_allclose(np.asarray(r), np.asarray(r_ref.T), atol=1e-11)


def test_sincos_accuracy():
    x = jnp.asarray(np.linspace(-6.5, 6.5, 20001), jnp.float32)
    s, c = LR.sincos(x)
    xs = np.asarray(x, np.float64)
    assert np.max(np.abs(np.asarray(s) - np.sin(xs))) < 2e-6
    assert np.max(np.abs(np.asarray(c) - np.cos(xs))) < 2e-6


def test_sincos_jvp_correct():
    """d sin = cos dx through the lane engine's sincos."""
    x = jnp.asarray(np.linspace(-6.0, 6.0, 101), jnp.float32)
    t = jnp.ones_like(x)
    (_, _), (ds, dc) = jax.jvp(LR.sincos, (x,), (t,))
    xs = np.asarray(x, np.float64)
    assert np.max(np.abs(np.asarray(ds) - np.cos(xs))) < 2e-5
    assert np.max(np.abs(np.asarray(dc) + np.sin(xs))) < 2e-5


def test_ldl_solve_matches_dense(rng):
    L = 7
    A = rng.normal(size=(L, 6, 6))
    M = np.einsum("lij,lkj->lik", A, A) + 3 * np.eye(6)
    b = rng.normal(size=(L, 6))
    Ml = [[jnp.asarray(M[:, i, j]) for j in range(6)] for i in range(6)]
    fac = LR.chol6(Ml)
    x = LR.chol6_solve(fac, [jnp.asarray(b[:, i]) for i in range(6)])
    x = np.stack([np.asarray(xi) for xi in x], axis=1)
    ref = np.linalg.solve(M, b[..., None])[..., 0]
    np.testing.assert_allclose(x, ref, rtol=1e-10, atol=1e-12)
