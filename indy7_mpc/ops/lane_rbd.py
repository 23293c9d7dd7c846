"""Lane-major structure-of-arrays rigid-body engine (the solver hot path).

This is the speed-of-light re-implementation of dynamics/: every quantity
is decomposed into scalar components over a flat lane axis ``L`` (lanes x
knots x line-search candidates), so the entire RNEA / CRBA / forward-
dynamics / integrator pipeline lowers to long chains of (L,)-shaped
elementwise ops that XLA fuses into a handful of kernels.  Design
choices, each worth a large factor over the generic layer:

  * 3-vectors are Python tuples of (L,) arrays and 3x3 matrices nested
    tuples — no stacking, no gathers, no transposes inside the recursions;
  * the robot model is baked in as *static numpy constants*: multiplies by
    0 / +-1 in the tree placements constant-fold away at trace time;
  * the 6x6 mass-matrix solve is a hand-unrolled LDL^T (no jnp.linalg.*,
    which lowers to batched library loops instead of joining the fused
    elementwise chain);
  * dynamics derivatives use 12 manual JVPs of the bias-only RNEA plus the
    factored mass matrix (da/du = M^-1 comes free from the Cholesky).

Numerical parity with dynamics/rnea.py, dynamics/kinematics.py and
dynamics/integrators.py is enforced by tests/test_lane_rbd.py; those
generic implementations remain the readable reference/oracle.

Reference behaviors reproduced (citations into /root/reference):
  pin.aba / rk4 (src/utils.py:3-18), computeABADerivatives-based
  linearization (src/osqp_solver.py:70-81), oMi[6].actInv world-wrench
  mapping (src/gato_mpc_batch_sample.py:151-161).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.robot import RobotModel

# ---------------------------------------------------------------------------
# Static (trace-time) model constants.
# ---------------------------------------------------------------------------


class StaticModel(NamedTuple):
    """Numpy copy of a RobotModel: constants baked into the compiled program."""

    tree_R: np.ndarray   # (nj, 3, 3)
    tree_p: np.ndarray   # (nj, 3)
    axis: np.ndarray     # (nj, 3)
    mass: np.ndarray     # (nj,)
    h: np.ndarray        # (nj, 3) first moments m*c
    I_o: np.ndarray      # (nj, 3, 3) inertia about joint origin
    gravity: np.ndarray  # (3,)
    nj: int
    q_lower: np.ndarray  # (nj,) joint position limits (cost barrier data)
    q_upper: np.ndarray  # (nj,)


def static_model(model: RobotModel) -> StaticModel:
    mass = np.asarray(model.mass, np.float64)
    com = np.asarray(model.com, np.float64)
    I_com = np.asarray(model.I_com, np.float64)
    I_o = np.zeros_like(I_com)
    for i in range(mass.shape[0]):
        c = com[i]
        I_o[i] = I_com[i] + mass[i] * (c @ c * np.eye(3) - np.outer(c, c))
    return StaticModel(
        tree_R=np.asarray(model.tree_R, np.float64),
        tree_p=np.asarray(model.tree_p, np.float64),
        axis=np.asarray(model.axis, np.float64),
        mass=mass,
        h=mass[:, None] * com,
        I_o=I_o,
        gravity=np.asarray(model.gravity, np.float64),
        nj=mass.shape[0],
        q_lower=np.asarray(model.q_lower, np.float64),
        q_upper=np.asarray(model.q_upper, np.float64),
    )


# ---------------------------------------------------------------------------
# Transcendentals: the plain jnp ops.  A polynomial sincos built on a
# (x + 1.5*2^23) - 1.5*2^23 rounding was used here once; XLA's algebraic
# simplifier is free to fold that rounding away, and did inside a kernel.
# ---------------------------------------------------------------------------

def sincos(x):
    """(sin x, cos x)."""
    return jnp.sin(x), jnp.cos(x)


# ---------------------------------------------------------------------------
# Tuple-of-(L,) algebra.  Scalars may be Python floats (constant-folded).
# ---------------------------------------------------------------------------

def v3(x, y, z):
    return (x, y, z)


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def sub3(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def smul3(s, a):
    return (s * a[0], s * a[1], s * a[2])


def cross3(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def mv33(M, a):
    """M (3x3 nested tuple) @ a."""
    return tuple(
        M[i][0] * a[0] + M[i][1] * a[1] + M[i][2] * a[2] for i in range(3)
    )


def mtv33(M, a):
    """M^T @ a."""
    return tuple(
        M[0][i] * a[0] + M[1][i] * a[1] + M[2][i] * a[2] for i in range(3)
    )


def mm33(A, B):
    return tuple(
        tuple(sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3))
        for i in range(3)
    )


def const33(M: np.ndarray):
    """3x3 numpy -> nested tuple of floats (trace-time constants)."""
    return tuple(tuple(float(M[i, j]) for j in range(3)) for i in range(3))


def const3(v: np.ndarray):
    return (float(v[0]), float(v[1]), float(v[2]))


def rot_axis_t(axis, c, s):
    """Rodrigues rotation about constant ``axis`` with cos/sin (L,) arrays."""
    ax, ay, az = axis
    one_c = 1.0 - c
    return (
        (c + ax * ax * one_c, ax * ay * one_c - az * s, ax * az * one_c + ay * s),
        (ay * ax * one_c + az * s, c + ay * ay * one_c, ay * az * one_c - ax * s),
        (az * ax * one_c - ay * s, az * ay * one_c + ax * s, c + az * az * one_c),
    )


# ---------------------------------------------------------------------------
# Kinematics.
# ---------------------------------------------------------------------------

def _local_placements(sm: StaticModel, q: Sequence):
    """Per-joint local placement (R_li as tuples, p_li as constant tuples)."""
    out = []
    for i in range(sm.nj):
        s, c = sincos(q[i])
        R_joint = rot_axis_t(const3(sm.axis[i]), c, s)
        R_li = mm33(const33(sm.tree_R[i]), R_joint)
        out.append((R_li, const3(sm.tree_p[i])))
    return out


def fk(sm: StaticModel, q: Sequence):
    """World placements of every joint frame.

    ``q`` is a length-nj sequence of (L,) arrays.  Returns lists of
    (R_world nested-tuple, p_world tuple) per joint.
    """
    Rs, ps = [], []
    R_w, p_w = None, None
    for i, (R_li, p_li) in enumerate(_local_placements(sm, q)):
        if i == 0:
            R_w, p_w = R_li, p_li
        else:
            p_w = add3(p_w, mv33(R_w, p_li))
            R_w = mm33(R_w, R_li)
        Rs.append(R_w)
        ps.append(p_w)
    return Rs, ps


def ee_pos(sm: StaticModel, q: Sequence):
    return fk(sm, q)[1][-1]


def ee_pos_jacobian(sm: StaticModel, q: Sequence):
    """EE position and 3 x nj Jacobian (columns as tuples)."""
    Rs, ps = fk(sm, q)
    p_ee = ps[-1]
    cols = []
    for i in range(sm.nj):
        axis_w = mv33(Rs[i], const3(sm.axis[i]))
        cols.append(cross3(axis_w, sub3(p_ee, ps[i])))
    return p_ee, cols


def world_wrench_to_ee(sm: StaticModel, q: Sequence, w: Sequence):
    """World wrench (f, n about world origin) -> EE joint local (f, n).

    Mirrors ``oMi[6].actInv`` (gato_mpc_batch_sample.py:272-282).
    ``w`` is a length-6 sequence of (L,) arrays.
    """
    Rs, ps = fk(sm, q)
    R, p = Rs[-1], ps[-1]
    f = (w[0], w[1], w[2])
    n = (w[3], w[4], w[5])
    f_l = mtv33(R, f)
    n_l = mtv33(R, sub3(n, cross3(p, f)))
    return f_l, n_l


# ---------------------------------------------------------------------------
# RNEA (bias + full), CRBA, Cholesky, forward dynamics.
# ---------------------------------------------------------------------------

def rnea(
    sm: StaticModel,
    q: Sequence,
    v: Sequence,
    a: Sequence,
    f_ext_ee=None,
    gravity: bool = True,
):
    """Inverse dynamics; all joint vectors are length-nj lists of (L,).

    ``f_ext_ee``: optional (f tuple, n tuple) local spatial force on the
    last link.  Returns a list of nj torque arrays.
    """
    nj = sm.nj
    zero = 0.0
    g = const3(sm.gravity) if gravity else (0.0, 0.0, 0.0)

    placements = _local_placements(sm, q)
    v_lin = [None] * nj
    v_ang = [None] * nj
    f_lin = [None] * nj
    f_ang = [None] * nj

    vp_lin = (zero, zero, zero)
    vp_ang = (zero, zero, zero)
    ap_lin = (-g[0], -g[1], -g[2])
    ap_ang = (zero, zero, zero)

    for i in range(nj):
        R, p = placements[i]
        axis = const3(sm.axis[i])
        qd, qdd = v[i], a[i]

        # motion transform parent -> child
        wi = mtv33(R, vp_ang)
        vi = mtv33(R, add3(vp_lin, cross3(vp_ang, p)))
        vJ = smul3(qd, axis)
        wi = add3(wi, vJ)

        ai_ang = mtv33(R, ap_ang)
        ai_lin = mtv33(R, add3(ap_lin, cross3(ap_ang, p)))
        # a += S qdd + v x vJ
        ai_ang = add3(ai_ang, add3(smul3(qdd, axis), cross3(wi, vJ)))
        ai_lin = add3(ai_lin, cross3(vi, vJ))

        m = float(sm.mass[i])
        h = const3(sm.h[i])
        I_o = const33(sm.I_o[i])
        # I * motion = (m v - h x w, I_o w + h x v)
        Iv_lin = sub3(smul3(m, vi), cross3(h, wi))
        Iv_ang = add3(mv33(I_o, wi), cross3(h, vi))
        Ia_lin = sub3(smul3(m, ai_lin), cross3(h, ai_ang))
        Ia_ang = add3(mv33(I_o, ai_ang), cross3(h, ai_lin))
        # f = I a + v x* (I v)
        fi_lin = add3(Ia_lin, cross3(wi, Iv_lin))
        fi_ang = add3(Ia_ang, add3(cross3(wi, Iv_ang), cross3(vi, Iv_lin)))

        if f_ext_ee is not None and i == nj - 1:
            fe, ne = f_ext_ee
            fi_lin = sub3(fi_lin, fe)
            fi_ang = sub3(fi_ang, ne)

        v_lin[i], v_ang[i] = vi, wi
        f_lin[i], f_ang[i] = fi_lin, fi_ang
        vp_lin, vp_ang = vi, wi
        ap_lin, ap_ang = ai_lin, ai_ang

    tau = [None] * nj
    for i in range(nj - 1, -1, -1):
        tau[i] = dot3(f_ang[i], const3(sm.axis[i]))
        if i > 0:
            R, p = placements[i]
            fp = mv33(R, f_lin[i])
            np_ = add3(mv33(R, f_ang[i]), cross3(p, fp))
            f_lin[i - 1] = add3(f_lin[i - 1], fp)
            f_ang[i - 1] = add3(f_ang[i - 1], np_)
    return tau


def crba(sm: StaticModel, q: Sequence):
    """Mass matrix as a 6x6 nested list of (L,) arrays (symmetric)."""
    nj = sm.nj
    placements = _local_placements(sm, q)

    # Composite inertias leaf -> root: (m scalar, h tuple, I_o 3x3 tuple).
    comp_m = [float(sm.mass[i]) for i in range(nj)]
    comp_h = [const3(sm.h[i]) for i in range(nj)]
    comp_I = [const33(sm.I_o[i]) for i in range(nj)]

    def shift_term(m, c, sign):
        cc = dot3(c, c)
        return tuple(
            tuple(
                sign * m * ((cc if i == j else 0.0) - c[i] * c[j])
                for j in range(3)
            )
            for i in range(3)
        )

    def add33(A, B):
        return tuple(
            tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3)
        )

    for i in range(nj - 1, 0, -1):
        R, p = placements[i]
        m = comp_m[i]
        h = comp_h[i]
        I_o = comp_I[i]
        c = smul3(1.0 / m if isinstance(m, float) else 1.0 / m, h)
        c_new = add3(mv33(R, c), p)
        I_c = add33(I_o, shift_term(m, c, -1.0))
        Rt = tuple(tuple(R[j][i2] for j in range(3)) for i2 in range(3))
        I_c_new = mm33(mm33(R, I_c), Rt)
        I_o_new = add33(I_c_new, shift_term(m, c_new, 1.0))
        comp_m[i - 1] = comp_m[i - 1] + m
        comp_h[i - 1] = add3(comp_h[i - 1], smul3(m, c_new))
        comp_I[i - 1] = add33(comp_I[i - 1], I_o_new)

    M = [[None] * nj for _ in range(nj)]
    for i in range(nj):
        axis = const3(sm.axis[i])
        F_lin = smul3(-1.0, cross3(comp_h[i], axis))
        F_ang = mv33(comp_I[i], axis)
        M[i][i] = dot3(F_ang, axis)
        j = i
        while j > 0:
            R, p = placements[j]
            F_lin_p = mv33(R, F_lin)
            F_ang_p = add3(mv33(R, F_ang), cross3(p, F_lin_p))
            F_lin, F_ang = F_lin_p, F_ang_p
            j -= 1
            M[i][j] = dot3(F_ang, const3(sm.axis[j]))
            M[j][i] = M[i][j]
    return M


def chol6(M):
    """Unrolled LDL^T factorization of a 6x6 SPD nested list of (L,).

    Square-root-free, which keeps it defined (and f32-stable) for the
    merely semi-definite Quu the Riccati sweep can produce: returns
    ``(L unit-lower nested list, D list, invD list)``; exactly 6 divisions.
    """
    n = 6
    Lc = [[None] * n for _ in range(n)]
    D = [None] * n
    invD = [None] * n
    for j in range(n):
        s = M[j][j]
        for k in range(j):
            s = s - Lc[j][k] * Lc[j][k] * D[k]
        D[j] = s
        invD[j] = 1.0 / s
        for i in range(j + 1, n):
            t = M[i][j]
            for k in range(j):
                t = t - Lc[i][k] * Lc[j][k] * D[k]
            Lc[i][j] = t * invD[j]
    return (Lc, D, invD)


def chol6_solve(fac, b):
    """Solve (L D L^T) x = b for one rhs (length-6 list of (L,)).

    Division-free: only multiplies by the precomputed invD.
    """
    Lc, _, invD = fac
    n = 6
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - Lc[i][k] * y[k]
        y[i] = s
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i] * invD[i]
        for k in range(i + 1, n):
            s = s - Lc[k][i] * x[k]
        x[i] = s
    return x


def forward_dynamics(
    sm: StaticModel,
    q: Sequence,
    v: Sequence,
    tau: Sequence,
    f_ext_ee=None,
    gravity: bool = True,
):
    """a = M(q)^-1 (tau - bias); returns (a list, chol factor for reuse)."""
    bias = rnea(sm, q, v, [0.0] * sm.nj, f_ext_ee=f_ext_ee, gravity=gravity)
    M = crba(sm, q)
    Lc = chol6(M)
    a = chol6_solve(Lc, [tau[i] - bias[i] for i in range(sm.nj)])
    return a, Lc


# ---------------------------------------------------------------------------
# Integrators and array-boundary helpers.
# ---------------------------------------------------------------------------

def _split(x):
    """(12, L) array -> (q list, v list)."""
    return [x[i] for i in range(6)], [x[6 + i] for i in range(6)]


def _wrench_tuple(w):
    """(6, L) array or None -> length-6 list or None."""
    if w is None:
        return None
    return [w[i] for i in range(6)]


def _f_ext_from_world(sm, q, w):
    if w is None:
        return None
    return world_wrench_to_ee(sm, q, _wrench_tuple(w))


def euler_step(sm: StaticModel, x, u, dt: float, wrench_world=None):
    """Explicit Euler on (12, L) state, (6, L) control arrays."""
    q, v = _split(x)
    f_ext = _f_ext_from_world(sm, q, wrench_world)
    a, _ = forward_dynamics(sm, q, v, [u[i] for i in range(6)], f_ext)
    out = [q[i] + dt * v[i] for i in range(6)] + [
        v[i] + dt * a[i] for i in range(6)
    ]
    return jnp.stack(out)


def rk4_step(sm: StaticModel, x, u, dt: float, wrench_world=None):
    """RK4 matching utils.py:3-18 (wrench mapped once at the start state)."""
    q, v = _split(x)
    uu = [u[i] for i in range(6)]
    f_ext = _f_ext_from_world(sm, q, wrench_world)

    def fd(qq, vv):
        return forward_dynamics(sm, qq, vv, uu, f_ext)[0]

    half = dt / 2.0
    k1q = v
    k1v = fd(q, v)
    q2 = [q[i] + half * k1q[i] for i in range(6)]
    k2q = [v[i] + half * k1v[i] for i in range(6)]
    k2v = fd(q2, k2q)
    q3 = [q[i] + half * k2q[i] for i in range(6)]
    k3q = [v[i] + half * k2v[i] for i in range(6)]
    k3v = fd(q3, k3q)
    q4 = [q[i] + dt * k3q[i] for i in range(6)]
    k4q = [v[i] + dt * k3v[i] for i in range(6)]
    k4v = fd(q4, k4q)
    out = [
        q[i] + dt / 6.0 * (k1q[i] + 2 * k2q[i] + 2 * k3q[i] + k4q[i])
        for i in range(6)
    ] + [
        v[i] + dt / 6.0 * (k1v[i] + 2 * k2v[i] + 2 * k3v[i] + k4v[i])
        for i in range(6)
    ]
    return jnp.stack(out)
