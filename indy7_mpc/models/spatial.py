"""Spatial (6D) rigid-body algebra in JAX.

Conventions
-----------
* Linear-first 6-vectors, matching Pinocchio's layout:
    motion  m = (v, w)   -- linear velocity at the frame origin, angular velocity
    force   f = (f, n)   -- linear force, moment about the frame origin
* A frame placement ``X = (R, p)`` maps local coordinates to parent
  coordinates: ``x_parent = R @ x_local + p``.
* All functions broadcast over arbitrary leading batch dimensions: a
  3-vector has shape ``(*batch, 3)`` and a rotation ``(*batch, 3, 3)``.

This is the foundation for the rigid-body layer replacing the
reference's Pinocchio dependency (see /root/reference/src/utils.py:1-21,
src/osqp_solver.py:70-81 for the behaviors being reproduced).
"""
from __future__ import annotations

import jax.numpy as jnp


def cross(a, b):
    """Batched 3D cross product, shapes (*batch, 3)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def hat(v):
    """Skew-symmetric matrix [v]_x with shape (*batch, 3, 3)."""
    z = jnp.zeros_like(v[..., 0])
    vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]
    rows = [
        jnp.stack([z, -vz, vy], axis=-1),
        jnp.stack([vz, z, -vx], axis=-1),
        jnp.stack([-vy, vx, z], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rotz(q):
    """Rotation about z by angle q; q shape (*batch,), result (*batch, 3, 3)."""
    c, s = jnp.cos(q), jnp.sin(q)
    z = jnp.zeros_like(q)
    o = jnp.ones_like(q)
    rows = [
        jnp.stack([c, -s, z], axis=-1),
        jnp.stack([s, c, z], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def rot_axis(axis, q):
    """Rodrigues rotation about a fixed unit ``axis`` (3,) by angle q (*batch,)."""
    c, s = jnp.cos(q), jnp.sin(q)
    K = hat(jnp.asarray(axis, dtype=q.dtype))
    eye = jnp.eye(3, dtype=q.dtype)
    return (
        eye
        + s[..., None, None] * K
        + (1.0 - c)[..., None, None] * (K @ K)
    )


def rpy_matrix(r, p, y):
    """URDF fixed-axis roll-pitch-yaw to rotation matrix: R = Rz(y) Ry(p) Rx(r)."""
    cr, sr = jnp.cos(r), jnp.sin(r)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cy, sy = jnp.cos(y), jnp.sin(y)
    return jnp.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


def mv(R, x):
    """Batched matrix-vector product: (*b, 3, 3) @ (*b, 3) -> (*b, 3)."""
    return jnp.einsum("...ij,...j->...i", R, x)


def mtv(R, x):
    """Batched R^T @ x."""
    return jnp.einsum("...ji,...j->...i", R, x)


# ---------------------------------------------------------------------------
# Spatial motion / force transforms between frames.
#
# X = (R, p): pose of frame B in frame A coordinates (x_A = R x_B + p).
# ---------------------------------------------------------------------------

def motion_to_child(R, p, v, w):
    """Express a spatial motion (v, w at A's origin in A axes) in frame B."""
    w_b = mtv(R, w)
    v_b = mtv(R, v + cross(w, p))
    return v_b, w_b


def motion_to_parent(R, p, v, w):
    """Express a spatial motion given in frame B at A's origin in A axes."""
    w_a = mv(R, w)
    v_a = mv(R, v) + cross(p, w_a)
    return v_a, w_a


def force_to_parent(R, p, f, n):
    """Express a spatial force (f, n about B's origin in B axes) in frame A."""
    f_a = mv(R, f)
    n_a = mv(R, n) + cross(p, f_a)
    return f_a, n_a


def force_to_child(R, p, f, n):
    """Express a spatial force (f, n about A's origin in A axes) in frame B.

    This is the transform the reference applies to map a world-frame wrench
    onto the end-effector joint frame (``oMi[6].actInv``,
    /root/reference/src/gato_mpc_batch_sample.py:272-282).
    """
    f_b = mtv(R, f)
    n_b = mtv(R, n - cross(p, f))
    return f_b, n_b


def cross_motion(v1, w1, v2, w2):
    """Spatial cross product of motions: (v1,w1) x (v2,w2)."""
    return cross(w1, v2) + cross(v1, w2), cross(w1, w2)


def cross_force(v, w, f, n):
    """Spatial cross product motion x* force (appears in Coriolis terms)."""
    return cross(w, f), cross(w, n) + cross(v, f)


def inertia_mul(m, h, I_o, v, w):
    """Apply a spatial inertia to a motion, all about the same frame origin.

    m: mass (*b,), h: first moment m*com (*b, 3),
    I_o: rotational inertia about the frame origin (*b, 3, 3).
    Returns the spatial momentum (p_lin, L) = (m v - h x w, I_o w + h x v).
    """
    p_lin = m[..., None] * v - cross(h, w)
    L = mv(I_o, w) + cross(h, v)
    return p_lin, L


def inertia_about_origin(mass, com, I_com):
    """Shift a rotational inertia from the COM to the frame origin.

    I_o = I_c + m * (c.c I - c c^T)  (parallel axis theorem).
    """
    c = com
    cc = jnp.einsum("...i,...i->...", c, c)
    outer = jnp.einsum("...i,...j->...ij", c, c)
    eye = jnp.eye(3, dtype=I_com.dtype)
    return I_com + mass[..., None, None] * (cc[..., None, None] * eye - outer)
