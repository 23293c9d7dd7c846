"""Lane-major batched SQP internals: linearize, cost blocks, Riccati, merit.

Companion to lane_rbd.py: the full SQP iteration in structure-of-arrays
layout with the lane batch riding the minormost axis.  Produces results
numerically identical to ops/kkt.py + ops/riccati.py + solvers/sqp.py in
the Gauss-Newton formulation (enforced by tests/test_lane_sqp.py); those
remain the readable oracle implementations.

Array conventions (lane-major):
  X: (N, 12, B), U: (N-1, 6, B), goals: (N, 3, B), xs: (12, B),
  wrench: (6, B) or None.
Riccati blocks: A (N-1, 12, 12, B), Bm (N-1, 12, 6, B), d (N-1, 12, B),
  Q (N, 12, 12, B), q (N, 12, B), R scalar-diag (N-1, B), r (N-1, 6, B).

Key tricks:
  * dynamics derivatives: 12 tangent passes through ``jax.linearize`` of
    the lane-major forward dynamics, batched with one vmap (the tangent
    axis folds into the elementwise lanes);
  * da/du = M^-1 recovered from the already-factored mass matrix — no
    extra tangent passes for control columns;
  * the Riccati scan runs its 12x12 products as batched matmuls and
    factors each 6x6 Quu with an unrolled square-root-free LDL^T (no
    jnp.linalg), re-symmetrizing S every knot;
  * the 8-alpha merit line search folds (alpha, knot) into the lane axis:
    one fused dynamics pass evaluates all candidates
    (osqp_sqp.py:49-74 semantics, mu = 10).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp

from ..config import CostConfig, SQPConfig
from . import lane_rbd as LR

NX, NQ, NU = 12, 6, 6


# ---------------------------------------------------------------------------
# Linearization (Euler step Jacobians) and GN cost blocks.
# ---------------------------------------------------------------------------

def linearize(sm: LR.StaticModel, x, u, dt: float, wrench=None):
    """Euler-step Jacobians on folded knots: x (12, L), u (6, L).

    Returns (A (12, 12, L), Bm (12, 6, L), xnext (12, L)).

    Derivatives use the RNEA-transpose identity instead of differentiating
    through the mass-matrix solve:  along the solution,
    ``tau = RNEA(q, v, a; f_ext(q))``, so
    ``da/d(q,v) = -M^-1 * d RNEA(q, v, a*; f_ext(q)) / d(q,v)`` with
    ``a*`` held fixed, and ``da/du = M^-1`` from the already-factored
    Cholesky.  The 12 tangent directions fold into the lane axis through
    ONE ``jax.jvp`` of the (solve-free) RNEA — jvp through the unrolled
    Cholesky produced modules XLA took minutes to compile.
    """
    L = x.shape[-1]
    dtype = x.dtype

    # Primal solve: a* and the Cholesky factor of M.
    q0, v0 = LR._split(x)
    fe0 = LR._f_ext_from_world(sm, q0, wrench)
    a0_l, Lc = LR.forward_dynamics(
        sm, q0, v0, [u[i] for i in range(NU)], fe0
    )
    a0 = jnp.stack(a0_l)

    # Tangent pass: d RNEA(q, v, a*; f_ext(q)) in 12 folded directions.
    xt = jnp.tile(x, (1, NX))          # (12, 12 L)
    at = jnp.tile(a0, (1, NX))
    wt = jnp.tile(wrench, (1, NX)) if wrench is not None else None

    def rnea_of_x(x_):
        q_, v_ = LR._split(x_)
        fe_ = LR._f_ext_from_world(sm, q_, wt)
        tau = LR.rnea(
            sm, q_, v_, [at[i] for i in range(NU)], f_ext_ee=fe_
        )
        return jnp.stack(tau)

    tangent = jnp.kron(jnp.eye(NX, dtype=dtype), jnp.ones((1, L), dtype))
    _, dtau = jax.jvp(rnea_of_x, (xt,), (tangent,))  # (6, 12 L)

    # da/dx columns: -M^-1 dtau_j ; da/du columns: M^-1 e_j.
    da_cols = []
    for j in range(NX):
        col = [dtau[i, j * L : (j + 1) * L] for i in range(NU)]
        sol = LR.chol6_solve(Lc, col)
        da_cols.append(tuple(-sol[i] for i in range(NU)))
    da_dx = jnp.stack(
        [jnp.stack(list(c)) for c in da_cols]
    )  # (12 tangents, 6, L)

    eye_cols = []
    for j in range(NU):
        e = [jnp.full((L,), 1.0 if i == j else 0.0, dtype) for i in range(NU)]
        eye_cols.append(LR.chol6_solve(Lc, e))  # column j of M^-1

    # Assemble A = [[I, dt I], [dt da/dq, I + dt da/dv]] and B = [0; dt M^-1]
    # by stacking (scatter updates compile and run far slower).
    eye6 = jnp.eye(NQ, dtype=dtype)
    zero6 = jnp.zeros((NQ, NQ), dtype)
    top = jnp.concatenate([eye6, dt * eye6], axis=1)[:, :, None]
    vel_eye = jnp.concatenate([zero6, eye6], axis=1)[:, :, None]
    bottom = dt * jnp.swapaxes(da_dx, 0, 1) + vel_eye  # (6, 12, L)
    A = jnp.concatenate([jnp.broadcast_to(top, (NQ, NX, L)), bottom])
    minv = jnp.stack(
        [jnp.stack(col) for col in eye_cols], axis=1
    )  # (i, j, L) = M^-1[i, j]
    Bm = jnp.concatenate([jnp.zeros((NQ, NU, L), dtype), dt * minv])

    q, v = LR._split(x)
    xnext = jnp.concatenate(
        [
            jnp.stack([q[i] + dt * v[i] for i in range(NQ)]),
            jnp.stack([v[i] + dt * a0[i] for i in range(NQ)]),
        ]
    )
    return A, Bm, xnext


class LaneBlocks(NamedTuple):
    A: jnp.ndarray   # (N-1, 12, 12, B)
    Bm: jnp.ndarray  # (N-1, 12, 6, B)
    d: jnp.ndarray   # (N-1, 12, B) defects
    Q: jnp.ndarray   # (N, 12, 12, B)
    q: jnp.ndarray   # (N, 12, B)
    Rdiag: jnp.ndarray  # (N-1, B) control weight (scalar diagonal)
    r: jnp.ndarray   # (N-1, 6, B)


def cost_scale(cfg: CostConfig, err_norm):
    if cfg.regularize:
        return 1.0 / (err_norm + cfg.eps)
    return jnp.ones_like(err_norm)


def build_blocks(
    sm: LR.StaticModel,
    cfg: CostConfig,
    X,
    U,
    goals,
    dt: float,
    wrench=None,
) -> LaneBlocks:
    """GN delta-variable QP blocks, lane-major (see kkt.build_qp_gn)."""
    N = X.shape[0]
    B = X.shape[-1]
    dtype = X.dtype

    # --- dynamics: fold knots into lanes -------------------------------
    Lfold = (N - 1) * B
    xf = jnp.reshape(X[:-1].swapaxes(0, 1), (NX, Lfold))
    uf = jnp.reshape(U.swapaxes(0, 1), (NU, Lfold))
    wf = None
    if wrench is not None:
        wf = jnp.reshape(
            jnp.broadcast_to(wrench[None], (N - 1, 6, B)).swapaxes(0, 1),
            (6, Lfold),
        )
    Af, Bf, xnextf = linearize(sm, xf, uf, dt, wrench=wf)
    A = jnp.reshape(Af, (NX, NX, N - 1, B)).transpose(2, 0, 1, 3)
    Bm = jnp.reshape(Bf, (NX, NU, N - 1, B)).transpose(2, 0, 1, 3)
    xnext = jnp.reshape(xnextf, (NX, N - 1, B)).swapaxes(0, 1)
    d = xnext - X[1:]

    # --- cost: fold all N knots ----------------------------------------
    Lc = N * B
    qf = [jnp.reshape(X[:, i].reshape(N * B), (Lc,)) for i in range(NQ)]
    eep, cols = LR.ee_pos_jacobian(sm, qf)
    gf = jnp.reshape(goals.swapaxes(0, 1), (3, Lc))
    err = [eep[i] - gf[i] for i in range(3)]
    err_norm = jnp.sqrt(err[0] ** 2 + err[1] ** 2 + err[2] ** 2)
    scale = cost_scale(cfg, err_norm)
    dQ_mod = cfg.dQ * scale
    R_mod = cfg.R * scale
    # terminal mask over knots
    term = jnp.reshape(
        jnp.broadcast_to(
            (jnp.arange(N) == N - 1)[:, None], (N, B)
        ),
        (Lc,),
    )
    Q_mod = jnp.where(term, cfg.QN, 1.0).astype(dtype)

    # Q = [[2 Qmod J^T J + Qmod diag(hb), 0], [0, 2 dQmod I]] and the
    # gradient [2 Qmod J^T err + Qmod gb; 2 dQmod v], stacked entry by
    # entry (barrier: kkt.barrier_terms semantics, Qmod-scaled like the EE
    # term).
    zero = jnp.zeros((Lc,), dtype)
    gb = [zero] * NQ
    hb = [zero] * NQ
    if cfg.q_barrier:
        w_b = cfg.q_barrier
        for i in range(NQ):
            hi = float(sm.q_upper[i]) - cfg.q_barrier_margin
            lo = float(sm.q_lower[i]) + cfg.q_barrier_margin
            d_hi = jnp.maximum(qf[i] - hi, 0.0)
            d_lo = jnp.maximum(lo - qf[i], 0.0)
            gb[i] = 2.0 * w_b * (d_hi - d_lo)
            hb[i] = 2.0 * w_b * jnp.logical_or(
                d_hi > 0.0, d_lo > 0.0
            ).astype(dtype)
    JtJ = {}
    for i in range(NQ):
        for j in range(i, NQ):
            JtJ[i, j] = JtJ[j, i] = 2.0 * Q_mod * LR.dot3(cols[i], cols[j])
    rows = []
    for i in range(NX):
        row = []
        for j in range(NX):
            if i < NQ and j < NQ:
                v = JtJ[i, j] + (Q_mod * hb[i] if i == j else 0.0)
            elif i == j:
                v = 2.0 * dQ_mod
            else:
                v = zero
            row.append(v)
        rows.append(jnp.stack(row))
    Qblk = jnp.stack(rows)
    vf = jnp.reshape(X[:, NQ:].swapaxes(0, 1), (NQ, Lc))
    grad = jnp.stack(
        [2.0 * Q_mod * LR.dot3(cols[i], err) + Q_mod * gb[i]
         for i in range(NQ)]
        + [2.0 * dQ_mod * vf[i] for i in range(NQ)]
    )

    Q = jnp.reshape(Qblk, (NX, NX, N, B)).transpose(2, 0, 1, 3)
    qvec = jnp.reshape(grad, (NX, N, B)).swapaxes(0, 1)
    Rknots = jnp.reshape(2.0 * R_mod, (N, B))[:-1]
    r = Rknots[:, None, :] * U

    return LaneBlocks(A=A, Bm=Bm, d=d, Q=Q, q=qvec, Rdiag=Rknots, r=r)


# ---------------------------------------------------------------------------
# Riccati sweep: batched 12x12 products + an unrolled 6x6 LDL^T.
# ---------------------------------------------------------------------------

def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def _ldl_inverse(M):
    """Inverse of a batch of SPD 6x6 matrices (B, 6, 6) through the
    square-root-free LDL^T (lane_rbd.chol6): defined for the merely
    semi-definite Quu a long f32 sweep can produce, where a Cholesky
    pivot would go NaN."""
    fac = LR.chol6([[M[:, i, j] for j in range(NU)] for i in range(NU)])
    cols = [
        LR.chol6_solve(fac, [1.0 if i == j else 0.0 for i in range(NU)])
        for j in range(NU)
    ]
    return jnp.stack([jnp.stack(c, axis=-1) for c in cols], axis=-1)


def riccati(blocks: LaneBlocks, xs_delta, rho):
    """Exact block-tridiagonal solve; see ops/riccati.py for the math.

    xs_delta: (12, B) pinned initial delta state; rho: (B,) Levenberg term.
    Returns (dX (N, 12, B), dU (N-1, 6, B)).

    Lanes lead inside the sweep, so each knot's products are a few
    batched 12x12 matmuls (float32 at "highest" precision: TF32 would
    round away what the recursion amplifies).  S is re-symmetrized every
    knot: the recursion amplifies the asymmetric f32 noise of A^T S A,
    and at N=64 unsymmetrized noise grows to O(|S|).
    """
    bm = lambda a: jnp.moveaxis(a, -1, 1)  # (N-1, ..., B) -> (N-1, B, ...)
    A, Bm = bm(blocks.A), bm(blocks.Bm)
    d, q = bm(blocks.d), bm(blocks.q)
    Q, r = bm(blocks.Q), bm(blocks.r)
    Rd = blocks.Rdiag
    mT = lambda M: jnp.swapaxes(M, -1, -2)
    mv = lambda M, v: jnp.einsum("bij,bj->bi", M, v)
    eye_u = jnp.eye(NU, dtype=A.dtype)

    def backward(carry, inp):
        S, s = carry
        A_, B_, d_, Q_, q_, R_, r_ = inp
        Sc = s + mv(S, d_)
        AtS = mT(A_) @ S
        Qxx = Q_ + AtS @ A_
        Qxu = AtS @ B_
        Quu = _sym(mT(B_) @ S @ B_) + (R_ + rho)[:, None, None] * eye_u
        qx = q_ + mv(mT(A_), Sc)
        qu = r_ + mv(mT(B_), Sc)
        Quu_inv = _ldl_inverse(Quu)
        K = -Quu_inv @ mT(Qxu)
        kff = -mv(Quu_inv, qu)
        S_new = _sym(Qxx + Qxu @ K)
        s_new = qx + mv(Qxu, kff)
        return (S_new, s_new), (K, kff)

    with jax.default_matmul_precision("highest"):
        (_, _), (K, kff) = jax.lax.scan(
            backward,
            (Q[-1], q[-1]),
            (A, Bm, d, Q[:-1], q[:-1], Rd, r),
            reverse=True,
        )

        def forward(x, inp):
            A_, B_, d_, K_, k_ = inp
            u = mv(K_, x) + k_
            return mv(A_, x) + mv(B_, u) + d_, (x, u)

        x_last, (dX, dU) = jax.lax.scan(
            forward, xs_delta.T, (A, Bm, d, K, kff)
        )
    dX = jnp.concatenate([dX, x_last[None]], axis=0)
    return jnp.moveaxis(dX, 1, -1), jnp.moveaxis(dU, 1, -1)


# ---------------------------------------------------------------------------
# Merit (nonlinear cost + constraint violation), folded over candidates.
# ---------------------------------------------------------------------------

def merit_batch(
    sm: LR.StaticModel,
    cfg: CostConfig,
    mu: float,
    Xc,
    Uc,
    goals,
    x0_prev,
    dt: float,
    wrench=None,
):
    """Merit for a stack of candidates: Xc (C, N, 12, B) -> (C, B).

    Matches solvers/sqp.py merit(): eepos_cost + mu * (integrator defect
    + initial-state deviation), osqp_sqp.py:49-66.
    """
    C, N = Xc.shape[0], Xc.shape[1]
    B = Xc.shape[-1]

    # tracking + velocity cost over all candidate knots
    Lc = C * N * B
    qf = [Xc[:, :, i].reshape(Lc) for i in range(NQ)]
    eep = LR.ee_pos(sm, qf)
    gf = jnp.broadcast_to(goals[None], (C, N, 3, B))
    gt = [gf[:, :, i].reshape(Lc) for i in range(3)]
    err2 = sum((eep[i] - gt[i]) ** 2 for i in range(3))
    term = jnp.broadcast_to(
        (jnp.arange(N) == N - 1)[None, :, None], (C, N, B)
    ).reshape(Lc)
    Q_mod = jnp.where(term, cfg.QN, 1.0)
    v2 = sum(Xc[:, :, NQ + i].reshape(Lc) ** 2 for i in range(NQ))
    pos2 = err2
    if cfg.q_barrier:  # joint-range barrier (kkt.barrier_terms)
        w_b = cfg.q_barrier
        for i in range(NQ):
            hi = float(sm.q_upper[i]) - cfg.q_barrier_margin
            lo = float(sm.q_lower[i]) + cfg.q_barrier_margin
            d_hi = jnp.maximum(qf[i] - hi, 0.0)
            d_lo = jnp.maximum(lo - qf[i], 0.0)
            pos2 = pos2 + w_b * (d_hi * d_hi + d_lo * d_lo)
    knot_cost = Q_mod * pos2 + cfg.dQ * v2
    cost = jnp.sum(knot_cost.reshape(C, N, B), axis=1)
    cost = cost + cfg.R * jnp.sum(Uc * Uc, axis=(1, 2))

    # integrator defect (Euler), folded over (C, N-1, B)
    Ld = C * (N - 1) * B
    xf = Xc[:, :-1].transpose(2, 0, 1, 3).reshape(NX, Ld)
    uf = Uc.transpose(2, 0, 1, 3).reshape(NU, Ld)
    wf = None
    if wrench is not None:
        wf = (
            jnp.broadcast_to(wrench[None, None], (C, N - 1, 6, B))
            .transpose(2, 0, 1, 3)
            .reshape(6, Ld)
        )
    pred = LR.euler_step(sm, xf, uf, dt, wrench_world=wf)
    nxt = Xc[:, 1:].transpose(2, 0, 1, 3).reshape(NX, Ld)
    diff2 = (pred - nxt) ** 2
    dq = jnp.sqrt(jnp.sum(diff2[:NQ], axis=0) + 1e-30)
    dv = jnp.sqrt(jnp.sum(diff2[NQ:], axis=0) + 1e-30)
    defect = jnp.sum((dq + dv).reshape(C, N - 1, B), axis=1)

    dx0 = Xc[:, 0] - x0_prev[None]
    cv = defect + jnp.sqrt(jnp.sum(dx0 * dx0, axis=1) + 1e-30)
    return cost + mu * cv
