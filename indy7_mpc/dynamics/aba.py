"""Articulated-body algorithm (ABA): O(n) forward dynamics in JAX.

Direct parity with the reference's ``pin.aba(model, data, q, v, u, f_ext)``
(/root/reference/src/utils.py:3-18, src/osqp_sqp.py:40): same continuous
dynamics as :func:`indy7_mpc.dynamics.rnea.forward_dynamics` (the
CRBA + Cholesky default), computed by Featherstone's articulated-body
recursion instead of an explicit mass-matrix solve.  Exposed both as a
numerical cross-check (tests assert ABA == CRBA-FD to machine precision)
and as the lower-flop option for very long rollouts.

Conventions follow models/spatial.py: linear-first 6-vectors, local
joint-frame recursions, gravity as a base acceleration.  Articulated
inertias are full symmetric 6x6 matrices in the (linear, angular) block
layout; all products broadcast over leading batch dims so the whole
recursion vmaps over lanes.
"""
from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from ..models import spatial
from ..models.robot import RobotModel
from .rnea import _ee_f_ext, _link_inertia


def _inertia6(m, h, I_o, batch, dtype):
    """Dense 6x6 spatial inertia [[m I, -hx], [hx, I_o]] (linear-first)."""
    hx = spatial.hat(jnp.broadcast_to(h.astype(dtype), batch + (3,)))
    mI = m * jnp.eye(3, dtype=dtype)
    top = jnp.concatenate([jnp.broadcast_to(mI, batch + (3, 3)), -hx], axis=-1)
    bot = jnp.concatenate(
        [hx, jnp.broadcast_to(I_o.astype(dtype), batch + (3, 3))], axis=-1
    )
    return jnp.concatenate([top, bot], axis=-2)


def _ia_to_parent(R, p, IA):
    """Transform an articulated inertia from child frame B to parent A.

    I_A = F I_B X  with the force map F = [[R, 0], [px R, R]] and the
    motion map (parent -> child) X = [[R^T, -R^T px], [0, R^T]].
    """
    batch = IA.shape[:-2]
    dtype = IA.dtype
    z3 = jnp.zeros(batch + (3, 3), dtype)
    Rb = jnp.broadcast_to(R, batch + (3, 3))
    px = spatial.hat(jnp.broadcast_to(p.astype(dtype), batch + (3,)))
    pxR = px @ Rb
    F = jnp.concatenate(
        [
            jnp.concatenate([Rb, z3], axis=-1),
            jnp.concatenate([pxR, Rb], axis=-1),
        ],
        axis=-2,
    )
    Rt = jnp.swapaxes(Rb, -1, -2)
    X = jnp.concatenate(
        [
            jnp.concatenate([Rt, -Rt @ px], axis=-1),
            jnp.concatenate([z3, Rt], axis=-1),
        ],
        axis=-2,
    )
    return F @ IA @ X


def aba(
    model: RobotModel,
    q,
    v,
    tau,
    f_ext: Optional[jnp.ndarray] = None,
    gravity: bool = True,
):
    """Forward dynamics by the articulated-body algorithm.

    Args:
      q, v, tau: ``(*batch, nj)`` position / velocity / torque.
      f_ext: optional ``(*batch, nj, 6)`` local spatial forces (f, n) per
        link (same layout as :func:`rnea.rnea`).
      gravity: include model.gravity if True.

    Returns joint accelerations ``(*batch, nj)``.
    """
    nj = model.nj
    batch = q.shape[:-1]
    dtype = q.dtype
    zero3 = jnp.zeros(batch + (3,), dtype)

    # --- Pass 1: velocities, bias accelerations, leaf inertias/forces.
    Rs, ps = [], []
    v_lin, v_ang = [], []
    c_lin, c_ang = [], []
    IA, pA_lin, pA_ang = [], [], []

    vp_lin, vp_ang = zero3, zero3
    for i in range(nj):
        R_joint = spatial.rot_axis(model.axis[i], q[..., i])
        R_li = model.tree_R[i] @ R_joint
        p_li = model.tree_p[i]
        Rs.append(R_li)
        ps.append(p_li)

        axis = model.axis[i]
        qd = v[..., i][..., None]

        vi_lin, vi_ang = spatial.motion_to_child(R_li, p_li, vp_lin, vp_ang)
        vJ_ang = axis * qd
        vi_ang = vi_ang + vJ_ang

        # c = v x vJ, vJ = (0, axis qd)
        ci_lin, ci_ang = spatial.cross_motion(
            vi_lin, vi_ang, 0.0 * vi_lin, vJ_ang
        )

        m, h, I_o = _link_inertia(model, i)
        Iv_lin, Iv_ang = spatial.inertia_mul(m, h, I_o, vi_lin, vi_ang)
        bi_lin, bi_ang = spatial.cross_force(vi_lin, vi_ang, Iv_lin, Iv_ang)
        if f_ext is not None:
            bi_lin = bi_lin - f_ext[..., i, :3]
            bi_ang = bi_ang - f_ext[..., i, 3:]

        v_lin.append(vi_lin); v_ang.append(vi_ang)
        c_lin.append(ci_lin); c_ang.append(ci_ang)
        IA.append(_inertia6(m, h, I_o, batch, dtype))
        pA_lin.append(bi_lin); pA_ang.append(bi_ang)
        vp_lin, vp_ang = vi_lin, vi_ang

    # --- Pass 2: articulated inertias, leaves -> root.
    s6 = [
        jnp.concatenate(
            [jnp.zeros(3, dtype), jnp.asarray(model.axis[i], dtype)]
        )
        for i in range(nj)
    ]
    U, d, u = [None] * nj, [None] * nj, [None] * nj
    for i in range(nj - 1, -1, -1):
        U[i] = jnp.einsum("...ij,j->...i", IA[i], s6[i])
        d[i] = jnp.einsum("...i,i->...", U[i], s6[i])
        pA6 = jnp.concatenate([pA_lin[i], pA_ang[i]], axis=-1)
        u[i] = tau[..., i] - jnp.einsum("...i,i->...", pA6, s6[i])
        if i > 0:
            Ia = IA[i] - jnp.einsum("...i,...j->...ij", U[i], U[i]) / (
                d[i][..., None, None]
            )
            c6 = jnp.concatenate([c_lin[i], c_ang[i]], axis=-1)
            pa6 = (
                pA6
                + jnp.einsum("...ij,...j->...i", Ia, c6)
                + U[i] * (u[i] / d[i])[..., None]
            )
            IA[i - 1] = IA[i - 1] + _ia_to_parent(Rs[i], ps[i], Ia)
            fp_lin, fp_ang = spatial.force_to_parent(
                Rs[i], ps[i], pa6[..., :3], pa6[..., 3:]
            )
            pA_lin[i - 1] = pA_lin[i - 1] + fp_lin
            pA_ang[i - 1] = pA_ang[i - 1] + fp_ang

    # --- Pass 3: accelerations, root -> leaves.
    if gravity:
        ap_lin = jnp.broadcast_to(-model.gravity.astype(dtype), batch + (3,))
    else:
        ap_lin = zero3
    ap_ang = zero3
    qdd = [None] * nj
    for i in range(nj):
        ai_lin, ai_ang = spatial.motion_to_child(Rs[i], ps[i], ap_lin, ap_ang)
        ai_lin = ai_lin + c_lin[i]
        ai_ang = ai_ang + c_ang[i]
        a6 = jnp.concatenate([ai_lin, ai_ang], axis=-1)
        qdd[i] = (u[i] - jnp.einsum("...i,...i->...", U[i], a6)) / d[i]
        ai_ang = ai_ang + model.axis[i] * qdd[i][..., None]
        ap_lin, ap_ang = ai_lin, ai_ang
    return jnp.stack(qdd, axis=-1)


def forward_dynamics_aba(
    model: RobotModel, q, v, tau, f_ext_ee=None, gravity: bool = True
):
    """Drop-in for :func:`rnea.forward_dynamics` using the ABA recursion.

    ``f_ext_ee``: optional ``(*batch, 6)`` local spatial force on the last
    link (see :func:`rnea.world_wrench_to_ee_joint`).
    """
    f_ext = None
    if f_ext_ee is not None:
        f_ext = _ee_f_ext(model, q.shape[:-1], q.dtype, f_ext_ee)
    return aba(model, q, v, tau, f_ext=f_ext, gravity=gravity)
