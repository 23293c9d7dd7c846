"""Schur-complement PCG solve of the block-tridiagonal KKT system.

This is the iterative QP backend the reference's CUDA solver uses (GATO:
per-iteration ``pcg_stats[i].pcg_iterations``, gato_controller.py:98-99;
see PAPERS.md, arXiv 2510.07625): eliminate the primal variables of the
equality-constrained QP and run preconditioned conjugate gradients on the
dual (multiplier) system

    S lam = gamma,      S = C H^{-1} C^T   (block tridiagonal, N x N
                                            blocks of nx x nx)

with a symmetric block-Jacobi preconditioner ``M_k = S_kk^{-1}``.  The
exact O(N) Riccati sweep (ops/riccati.py) stays the default backend; PCG
is the parity backend and the horizon-parallel one — its matvec touches
all N knots simultaneously (batched einsums over the knot axis), so a
CG iteration is O(1) fused launches instead of a length-N scan
dependency chain.

QP solved (same as ops/riccati.py):

    min  sum_k 0.5 x_k^T Q_k x_k + q_k^T x_k
         + sum_{k<N-1} 0.5 u_k^T (R_k + rho I) u_k + r_k^T u_k
    s.t. x_0 = xs,   x_{k+1} = A_k x_k + B_k u_k + c_k

Because the Schur complement needs ``H^{-1}``, the state blocks must be
positive definite; both cost formulations produce rank-deficient position
blocks (rank-1 outer product / rank-3 J^T J), so this backend adds a
primal regularization ``primal_reg * I`` to every Q_k.  Pass the same
regularization to the Riccati oracle when comparing.

Everything is single-lane and ``vmap``-able over lanes; all block algebra
is batched over the knot axis (no Python loops over N).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .kkt import QPBlocks


class PCGSolution(NamedTuple):
    X: jnp.ndarray          # (N, nx)
    U: jnp.ndarray          # (N-1, nu)
    lam: jnp.ndarray        # (N, nx) multipliers
    iterations: jnp.ndarray  # () CG iterations used (pcg_stats parity)
    residual: jnp.ndarray   # () final |S lam - gamma|


def _chol_inv(M):
    """Batched SPD inverse via Cholesky; M: (..., n, n)."""
    L = jnp.linalg.cholesky(M)
    eye = jnp.broadcast_to(jnp.eye(M.shape[-1], dtype=M.dtype), M.shape)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    return jnp.swapaxes(Linv, -1, -2) @ Linv


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def build_schur(blocks: QPBlocks, rho, primal_reg):
    """Form the dual Schur system ``S lam = gamma`` from QP blocks.

    Multiplier layout: lam_0 <-> (x_0 = xs); lam_{k+1} <-> dynamics row
    ``A_k x_k + B_k u_k - x_{k+1} = -c_k``.

    Returns (D, Uo, g_dyn, W, V, Wq, Vr): D (N, nx, nx) diagonal blocks,
    Uo (N-1, nx, nx) superdiagonal blocks ``S_{k,k+1}``, g_dyn (N-1, nx)
    the dynamics rows of the RHS (the initial-state row depends on xs and
    is assembled by the caller), W/V the inverted cost blocks and Wq/Vr
    their products with the gradients (reused for primal recovery).
    """
    A, B, c, Q, q, R, r = blocks
    N, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[-1]
    dtype = Q.dtype

    eye_x = jnp.eye(nx, dtype=dtype)
    eye_u = jnp.eye(nu, dtype=dtype)
    W = _chol_inv(_sym(Q) + primal_reg * eye_x)        # (N, nx, nx)
    V = _chol_inv(_sym(R) + rho * eye_u)               # (N-1, nu, nu)

    AW = jnp.einsum("kij,kjl->kil", A, W[:-1])          # A_k W_k
    BV = jnp.einsum("kij,kjl->kil", B, V)               # B_k V_k

    # Diagonal: S_00 = W_0; S_{k+1,k+1} = A W A' + B V B' + W_{k+1}.
    D_dyn = (
        jnp.einsum("kil,kjl->kij", AW, A)
        + jnp.einsum("kil,kjl->kij", BV, B)
        + W[1:]
    )
    D = jnp.concatenate([W[:1], D_dyn], axis=0)

    # Superdiagonal: S_{0,1} = W_0 A_0'; S_{k+1,k+2} = -W_{k+1} A_{k+1}'.
    WAt = jnp.einsum("kij,klj->kil", W[:-1], A)         # W_k A_k'
    Uo = jnp.concatenate([WAt[:1], -WAt[1:]], axis=0)

    # RHS gamma = -(d + C H^{-1} g), d = (xs handled by caller, -c_k).
    Wq = jnp.einsum("kij,kj->ki", W, q)                 # W_k q_k
    Vr = jnp.einsum("kij,kj->ki", V, r)                 # V_k r_k
    g_dyn = -(
        -c
        + jnp.einsum("kij,kj->ki", A, Wq[:-1])
        + jnp.einsum("kij,kj->ki", B, Vr)
        - Wq[1:]
    )
    return D, Uo, g_dyn, W, V, Wq, Vr


def _matvec(D, Uo, lam):
    """(S lam)_k = D_k lam_k + Uo_k lam_{k+1} + Uo_{k-1}' lam_{k-1}."""
    y = jnp.einsum("kij,kj->ki", D, lam)
    up = jnp.einsum("kij,kj->ki", Uo, lam[1:])          # (N-1, nx) at rows 0..N-2
    dn = jnp.einsum("kji,kj->ki", Uo, lam[:-1])         # rows 1..N-1
    y = y.at[:-1].add(up).at[1:].add(dn)
    return y


def solve(
    blocks: QPBlocks,
    xs,
    rho,
    primal_reg: float = 1e-6,
    tol: float = 1e-8,
    max_iters: int = 100,
) -> PCGSolution:
    """Solve the block-tridiagonal QP by dual PCG (single lane; vmap over
    lanes).  ``xs`` is the pinned initial state (or initial-state delta for
    the GN formulation).  Matches ops/riccati.py:solve on the same blocks
    when ``primal_reg`` is added to Q on both sides.
    """
    A, B, c, Q, q, R, r = blocks
    dtype = Q.dtype
    D, Uo, g_dyn, W, V, Wq, Vr = build_schur(blocks, rho, primal_reg)
    gamma = jnp.concatenate([-(xs + Wq[0])[None], g_dyn], axis=0)

    Minv = _chol_inv(D)  # block-Jacobi preconditioner

    def precond(rvec):
        return jnp.einsum("kij,kj->ki", Minv, rvec)

    lam0 = jnp.zeros_like(gamma)
    r0 = gamma - _matvec(D, Uo, lam0)
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)
    # Scale-aware exit: |r| <= tol * max(1, |gamma|).
    stop2 = (tol * jnp.maximum(1.0, jnp.linalg.norm(gamma))) ** 2

    def cond(state):
        _, rvec, _, _, _, it = state
        return jnp.logical_and(it < max_iters, jnp.vdot(rvec, rvec) > stop2)

    def body(state):
        lam, rvec, z, p, rz, it = state
        Sp = _matvec(D, Uo, p)
        alpha = rz / jnp.vdot(p, Sp)
        lam = lam + alpha * p
        rvec = rvec - alpha * Sp
        z = precond(rvec)
        rz_new = jnp.vdot(rvec, z)
        p = z + (rz_new / rz) * p
        return lam, rvec, z, p, rz_new, it + 1

    lam, rvec, _, _, _, iters = jax.lax.while_loop(
        cond, body, (lam0, r0, z0, p0, rz0, jnp.asarray(0, jnp.int32))
    )

    # Primal recovery: z = -H^{-1}(g + C' lam).
    # x_k picks up +lam_0 (k=0), +A_k' lam_{k+1} (k<N-1), -lam_k (k>0).
    ctl = jnp.einsum("kji,kj->ki", A, lam[1:])          # A_k' lam_{k+1}
    grad_x = q
    grad_x = grad_x.at[0].add(lam[0])
    grad_x = grad_x.at[:-1].add(ctl)
    grad_x = grad_x.at[1:].add(-lam[1:])
    X = -jnp.einsum("kij,kj->ki", W, grad_x)
    U = -jnp.einsum(
        "kij,kj->ki", V, r + jnp.einsum("kji,kj->ki", B, lam[1:])
    )
    return PCGSolution(
        X=X, U=U, lam=lam, iterations=iters,
        residual=jnp.linalg.norm(rvec).astype(dtype),
    )
