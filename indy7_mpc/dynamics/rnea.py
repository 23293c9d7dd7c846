"""Rigid-body dynamics: RNEA, CRBA, and forward dynamics (batched JAX).

JAX replacement for the reference's Pinocchio calls:
  * ``pin.aba(model, data, q, v, u[, f_ext])``
    (/root/reference/src/utils.py:3-18, src/osqp_sqp.py:40) ->
    :func:`forward_dynamics` (mass-matrix solve; same continuous dynamics).
  * external wrench handling ``oMi[6].actInv(world_force)``
    (/root/reference/src/gato_mpc_batch_sample.py:151-161, 272-282) ->
    :func:`world_wrench_to_ee_joint`.

Spatial quantities are linear-first: motion = (v, w), force = (f, n).
Recursions run in local joint frames (Featherstone RBDA Table 5.1) with the
gravity-as-base-acceleration trick.  The 6-joint loops are static Python
loops, unrolled at trace time; everything broadcasts over leading batch
dims, so under ``vmap``/``jit`` each 3-vector op becomes a fused
elementwise op over the lane batch.
"""
from __future__ import annotations

import os
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _inner_jit(fn=None, **jit_kwargs):
    """jax.jit unless INDY7_INNER_JIT=0.

    The inner jit makes repeated trace re-entries reuse one cached
    jaxpr (3.5x faster solver traces — the CPU test lane's dominant
    cost), but the extra function boundaries measurably slow XLA:CPU
    compilation of very large programs (the N=64 lane-sharded loop);
    multi-process workers whose gloo pairs idle-time-out during long
    compiles disable it (examples/multihost_bench.py).
    """
    if os.environ.get("INDY7_INNER_JIT", "1") == "0":
        return fn if fn is not None else (lambda f: f)
    if fn is None:
        return partial(jax.jit, **jit_kwargs)
    return jax.jit(fn, **jit_kwargs)

from ..models import spatial
from ..models.robot import RobotModel
from .kinematics import joint_frames


def _link_inertia(model: RobotModel, i):
    """(mass, first moment h = m c, inertia about joint origin) of link i."""
    m = model.mass[i]
    h = m * model.com[i]
    I_o = spatial.inertia_about_origin(
        model.mass[i][None], model.com[i][None], model.I_com[i][None]
    )[0]
    return m, h, I_o


@_inner_jit(static_argnames=("gravity",))
def rnea(
    model: RobotModel,
    q,
    v,
    a,
    f_ext: Optional[jnp.ndarray] = None,
    gravity: bool = True,
):
    """Inverse dynamics: joint torques realizing acceleration ``a``.

    Wrapped in an inner ``jax.jit``: the readable solver re-enters RNEA
    ~15x per trace (linearization JVPs, merit integrators); the inner
    jit makes those re-entries reuse one cached jaxpr instead of
    re-tracing the whole recursion each time (~3x faster solver traces
    on the CPU test rig; identical compiled code — XLA inlines it).

    Args:
      q, v, a: ``(*batch, nj)`` joint position / velocity / acceleration.
      f_ext: optional ``(*batch, nj, 6)`` external spatial forces (f, n)
        applied to each link, expressed in that link's joint frame.
      gravity: include gravity (model.gravity) if True.

    Returns ``tau`` with shape ``(*batch, nj)``.
    """
    nj = model.nj
    batch = q.shape[:-1]
    dtype = q.dtype
    zero3 = jnp.zeros(batch + (3,), dtype)

    if gravity:
        a0_lin = jnp.broadcast_to(-model.gravity, batch + (3,))
    else:
        a0_lin = zero3

    v_lin, v_ang = [], []
    a_lin, a_ang = [], []
    f_lin, f_ang = [], []
    Rs, ps = [], []  # local (parent->joint) placements, cached for backward pass

    vp_lin, vp_ang = zero3, zero3
    ap_lin, ap_ang = a0_lin, zero3
    for i in range(nj):
        R_joint = spatial.rot_axis(model.axis[i], q[..., i])
        R_li = model.tree_R[i] @ R_joint
        p_li = model.tree_p[i]
        Rs.append(R_li)
        ps.append(p_li)

        axis = model.axis[i]
        qd = v[..., i][..., None]
        qdd = a[..., i][..., None]

        vi_lin, vi_ang = spatial.motion_to_child(R_li, p_li, vp_lin, vp_ang)
        vJ_ang = axis * qd
        vi_ang = vi_ang + vJ_ang

        ai_lin, ai_ang = spatial.motion_to_child(R_li, p_li, ap_lin, ap_ang)
        # a += S qdd + v x vJ   (vJ = (0, axis qd))
        cx_lin, cx_ang = spatial.cross_motion(vi_lin, vi_ang, 0.0 * vi_lin, vJ_ang)
        ai_ang = ai_ang + axis * qdd + cx_ang
        ai_lin = ai_lin + cx_lin

        m, h, I_o = _link_inertia(model, i)
        Iv_lin, Iv_ang = spatial.inertia_mul(m, h, I_o, vi_lin, vi_ang)
        Ia_lin, Ia_ang = spatial.inertia_mul(m, h, I_o, ai_lin, ai_ang)
        vx_lin, vx_ang = spatial.cross_force(vi_lin, vi_ang, Iv_lin, Iv_ang)
        fi_lin = Ia_lin + vx_lin
        fi_ang = Ia_ang + vx_ang
        if f_ext is not None:
            fi_lin = fi_lin - f_ext[..., i, :3]
            fi_ang = fi_ang - f_ext[..., i, 3:]

        v_lin.append(vi_lin); v_ang.append(vi_ang)
        a_lin.append(ai_lin); a_ang.append(ai_ang)
        f_lin.append(fi_lin); f_ang.append(fi_ang)
        vp_lin, vp_ang = vi_lin, vi_ang
        ap_lin, ap_ang = ai_lin, ai_ang

    tau = [None] * nj
    for i in range(nj - 1, -1, -1):
        tau[i] = jnp.einsum("...i,i->...", f_ang[i], model.axis[i])
        if i > 0:
            fp_lin, fp_ang = spatial.force_to_parent(
                Rs[i], ps[i], f_lin[i], f_ang[i]
            )
            f_lin[i - 1] = f_lin[i - 1] + fp_lin
            f_ang[i - 1] = f_ang[i - 1] + fp_ang
    return jnp.stack(tau, axis=-1)


def _inertia_to_parent(R, p, m, h, I_o):
    """Shift a spatial inertia (about frame B origin) into frame A, X=(R,p).

    ``m``: (*b,), ``h``: (*b, 3), ``I_o``: (*b, 3, 3).
    """
    def _shift(mass, c, I, sign):
        # sign=-1: remove parallel-axis term; sign=+1: add it.
        return I + sign * mass[..., None, None] * (
            jnp.einsum("...i,...i->...", c, c)[..., None, None]
            * jnp.eye(3, dtype=I_o.dtype)
            - jnp.einsum("...i,...j->...ij", c, c)
        )

    c = h / m[..., None]
    c_new = spatial.mv(R, c) + p
    I_c = _shift(m, c, I_o, -1.0)
    I_c_new = R @ I_c @ jnp.swapaxes(R, -1, -2)
    I_o_new = _shift(m, c_new, I_c_new, 1.0)
    return m, m[..., None] * c_new, I_o_new


@_inner_jit
def crba(model: RobotModel, q) -> jnp.ndarray:
    """Joint-space mass matrix via the composite-rigid-body algorithm.

    Returns ``M`` with shape ``(*batch, nj, nj)`` (symmetric, PD).
    """
    nj = model.nj
    batch = q.shape[:-1]
    dtype = q.dtype

    Rs, ps = [], []
    for i in range(nj):
        R_joint = spatial.rot_axis(model.axis[i], q[..., i])
        Rs.append(model.tree_R[i] @ R_joint)
        ps.append(model.tree_p[i])

    # Composite inertias, leaves -> root.
    comp = []
    for i in range(nj):
        m, h, I_o = _link_inertia(model, i)
        comp.append([
            jnp.broadcast_to(jnp.asarray(m, dtype), batch),
            jnp.broadcast_to(h.astype(dtype), batch + (3,)),
            jnp.broadcast_to(I_o.astype(dtype), batch + (3, 3)),
        ])
    for i in range(nj - 1, 0, -1):
        m, h, I_o = _inertia_to_parent(
            Rs[i], ps[i], comp[i][0], comp[i][1], comp[i][2]
        )
        comp[i - 1][0] = comp[i - 1][0] + m
        comp[i - 1][1] = comp[i - 1][1] + h
        comp[i - 1][2] = comp[i - 1][2] + I_o

    M = [[None] * nj for _ in range(nj)]
    for i in range(nj):
        mi, hi, Ii = comp[i]
        # F = I^c S,  S = (0, axis): force = (-h x axis, I_o axis)
        F_lin = -spatial.cross(hi, jnp.broadcast_to(model.axis[i], batch + (3,)))
        F_ang = spatial.mv(Ii, jnp.broadcast_to(model.axis[i], batch + (3,)))
        M[i][i] = jnp.einsum("...k,k->...", F_ang, model.axis[i])
        j = i
        while j > 0:
            F_lin, F_ang = spatial.force_to_parent(Rs[j], ps[j], F_lin, F_ang)
            j -= 1
            M[i][j] = jnp.einsum("...k,k->...", F_ang, model.axis[j])
            M[j][i] = M[i][j]
    return jnp.stack(
        [jnp.stack(row, axis=-1) for row in M], axis=-2
    )


def world_wrench_to_ee_joint(model: RobotModel, q, wrench_world):
    """Map a world-frame wrench onto the EE joint's local frame.

    ``wrench_world = (fx, fy, fz, nx, ny, nz)`` is a spatial force expressed
    in the world frame (moment about the world origin), exactly the
    semantics of ``data.oMi[6].actInv(pin.Force(f, n))`` in the reference
    (gato_mpc_batch_sample.py:151-161).  Returns a ``(*batch, 6)`` local
    spatial force to feed :func:`forward_dynamics`.
    """
    R, p = joint_frames(model, q)
    R_ee, p_ee = R[..., -1, :, :], p[..., -1, :]
    f = wrench_world[..., :3]
    n = wrench_world[..., 3:]
    f_l, n_l = spatial.force_to_child(R_ee, p_ee, f, n)
    return jnp.concatenate([f_l, n_l], axis=-1)


def _ee_f_ext(model: RobotModel, batch, dtype, f_ext_ee):
    """Expand an EE-only local wrench to the per-joint (nj, 6) layout."""
    f_ext = jnp.zeros(batch + (model.nj, 6), dtype)
    return f_ext.at[..., -1, :].set(f_ext_ee)


def bias_forces(model: RobotModel, q, v, f_ext_ee=None, gravity: bool = True):
    """C(q, v) v + g(q) - J^T f_ext: RNEA at zero acceleration."""
    f_ext = None
    if f_ext_ee is not None:
        f_ext = _ee_f_ext(model, q.shape[:-1], q.dtype, f_ext_ee)
    return rnea(model, q, v, jnp.zeros_like(q), f_ext=f_ext, gravity=gravity)


def forward_dynamics(
    model: RobotModel, q, v, tau, f_ext_ee=None, gravity: bool = True
) -> jnp.ndarray:
    """Joint accelerations: ``a = M(q)^-1 (tau - bias(q, v, f_ext))``.

    Numerically identical to the reference's ``pin.aba`` (same continuous
    model); implemented as CRBA + Cholesky solve: a batched 6x6 solve
    beside the RNEA bias computation.

    ``f_ext_ee``: optional ``(*batch, 6)`` spatial force on the last link in
    its local joint frame (use :func:`world_wrench_to_ee_joint` to build it
    from a world wrench).
    """
    b = bias_forces(model, q, v, f_ext_ee=f_ext_ee, gravity=gravity)
    M = crba(model, q)
    rhs = (tau - b)[..., None]
    return jnp.linalg.solve(M, rhs)[..., 0]
