"""Horizon-parallel Riccati: LQR backward pass as an associative scan.

SURVEY.md section 5.7: the reference's "sequence" axis is the horizon N,
coupled through the block-tridiagonal KKT and solved sequentially (ADMM
on CPU, PCG on GPU).  The batched equivalent of sequence parallelism
is a *parallel-scan* Riccati sweep: the backward recursion is recast as
an associative combination of conditional-value-function elements
(Sarkka & Garcia-Fernandez, "Temporal Parallelization of Dynamic
Programming / LQT"), so the O(N) dependency chain becomes O(log N) depth
under ``jax.lax.associative_scan`` — all knots combine simultaneously in
each of the log2(N) levels, each level a batch of small dense solves that
XLA fuses across lanes and knots.

Element semantics: a = (F, c, C, eta, J) represents the partially
minimized cost kernel between states x (entry) and z (exit)

    psi(x, z) = 0.5 (z - F x - c)' C^+ (z - F x - c)
                + 0.5 x' J x - eta' x     (+ const)

Combination (min over the shared intermediate state) is associative:

    F  = F2 (I + C1 J2)^-1 F1
    c  = F2 (I + C1 J2)^-1 (c1 + C1 eta2) + c2
    C  = F2 (I + C1 J2)^-1 C1 F2' + C2
    eta= F1' (I + J2 C1)^-1 (eta2 - J2 c1) + eta1
    J  = F1' (I + J2 C1)^-1 J2 F1 + J1

Solves the identical QP as ops/riccati.py (same rho-on-Quu semantics);
tests assert exact agreement.  Per-solve flops are ~2x the sequential
sweep — worth it when the horizon, not the lane batch, is the scaling
axis.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .kkt import QPBlocks
from .riccati import RiccatiSolution, _sym


def _combine(a1, a2):
    """Associative combination of value-function elements (a1 earlier)."""
    F1, c1, C1, e1, J1 = a1
    F2, c2, C2, e2, J2 = a2
    nx = F1.shape[-1]
    eye = jnp.eye(nx, dtype=F1.dtype)

    # (I + C1 J2)^-1 applied from the left; shared for F, c, C.
    M = eye + C1 @ J2
    Minv_F1 = jnp.linalg.solve(M, F1)
    Minv_rhs = jnp.linalg.solve(
        M, (c1 + jnp.einsum("...ij,...j->...i", C1, e2))[..., None]
    )[..., 0]
    Minv_C1 = jnp.linalg.solve(M, C1)

    F = F2 @ Minv_F1
    c = jnp.einsum("...ij,...j->...i", F2, Minv_rhs) + c2
    C = F2 @ Minv_C1 @ jnp.swapaxes(F2, -1, -2) + C2

    # (I + J2 C1)^-1 applied from the left; shared for eta, J.
    Mt = eye + J2 @ C1
    rhs_e = e2 - jnp.einsum("...ij,...j->...i", J2, c1)
    Mtinv_e = jnp.linalg.solve(Mt, rhs_e[..., None])[..., 0]
    Mtinv_J2 = jnp.linalg.solve(Mt, J2)

    F1T = jnp.swapaxes(F1, -1, -2)
    eta = jnp.einsum("...ij,...j->...i", F1T, Mtinv_e) + e1
    J = F1T @ Mtinv_J2 @ F1 + J1
    return (F, c, C, eta, _sym(J))


def backward_pscan(blocks: QPBlocks, rho):
    """Cost-to-go (S_k, s_k) for every knot via one associative scan.

    Returns (S, s) with shapes (N, nx, nx), (N, nx):
    V_k(x) = 0.5 x' S_k x + s_k' x (+ const).
    """
    A, B, c, Q, q, R, r = blocks
    Nm1, nx, nu = B.shape
    dtype = A.dtype
    eye_u = jnp.eye(nu, dtype=dtype)

    # Fold rho into the control cost: matches riccati.py's Quu + rho I.
    Rr = _sym(R) + rho * eye_u
    Rc = jnp.linalg.cholesky(Rr)
    Rinv_Bt = jax.scipy.linalg.cho_solve(
        (Rc, True), jnp.swapaxes(B, -1, -2)
    )                                             # R^-1 B'
    Rinv_r = jax.scipy.linalg.cho_solve((Rc, True), r[..., None])[..., 0]

    # Step elements k = 0..N-2.
    F_s = A
    c_s = c - jnp.einsum("kij,kj->ki", B, Rinv_r)
    C_s = B @ Rinv_Bt
    eta_s = -q[:-1]
    J_s = _sym(Q[:-1])

    # Terminal element.
    zmat = jnp.zeros((1, nx, nx), dtype)
    zvec = jnp.zeros((1, nx), dtype)
    elems = (
        jnp.concatenate([F_s, zmat], axis=0),
        jnp.concatenate([c_s, zvec], axis=0),
        jnp.concatenate([C_s, zmat], axis=0),
        jnp.concatenate([eta_s, -q[-1:]], axis=0),
        jnp.concatenate([J_s, _sym(Q[-1:])], axis=0),
    )

    # reverse=True feeds fn(suffix-combined-later, new-earlier-element);
    # _combine's convention is (earlier, later), so swap.
    Fo, co, Co, eta, J = jax.lax.associative_scan(
        lambda x, y: _combine(y, x), elems, reverse=True
    )
    return J, -eta


def solve_pscan(blocks: QPBlocks, xs, rho) -> RiccatiSolution:
    """Exact block-tridiagonal QP solve, horizon-parallel backward pass.

    Same problem and rho semantics as :func:`riccati.solve`; the forward
    rollout recomputes the per-knot gains from the scanned cost-to-go.
    """
    A, B, c, Q, q, R, r = blocks
    nu = B.shape[-1]
    eye_u = jnp.eye(nu, dtype=A.dtype)
    S, s = backward_pscan(blocks, rho)

    def gains(k_inputs):
        Ak, Bk, ck, rk, Rk, S1, s1 = k_inputs
        Sc = s1 + S1 @ ck
        Quu = _sym(Rk + Bk.T @ S1 @ Bk) + rho * eye_u
        L = jnp.linalg.cholesky(Quu)
        rhs = jnp.concatenate(
            [Bk.T @ S1 @ Ak, (rk + Bk.T @ Sc)[:, None]], axis=1
        )
        sol = jax.scipy.linalg.cho_solve((L, True), rhs)
        return -sol[:, :-1], -sol[:, -1]

    K, kff = jax.vmap(gains)((A, B, c, r, R, S[1:], s[1:]))

    def step(x, inp):
        Ak, Bk, ck, Kk, kk = inp
        u = Kk @ x + kk
        x_next = Ak @ x + Bk @ u + ck
        return x_next, (x, u)

    x_last, (X, U) = jax.lax.scan(step, xs, (A, B, c, K, kff))
    X = jnp.concatenate([X, x_last[None]], axis=0)
    return RiccatiSolution(X=X, U=U, K=K, kff=kff)
