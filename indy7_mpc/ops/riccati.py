"""Batched block-tridiagonal KKT solve via an affine Riccati sweep.

This is the batched answer to the reference's two QP backends — OSQP's ADMM on
a sparse CSC KKT (osqp_solver.py:137-143) and the CUDA solver's
Schur-complement PCG (gato_controller.py:98-99): an *exact* O(N) backward/
forward sweep over the horizon, ``vmap``-able over thousands of lanes.
The horizon recursion is a ``lax.scan``; every step is a handful of
(nx+nu)-sized dense ops which XLA fuses and batches across lanes.

QP solved (absolute variables, equality-constrained):

    min  sum_k 0.5 x_k^T Q_k x_k + q_k^T x_k
         + sum_{k<N-1} 0.5 u_k^T R_k u_k + r_k^T u_k
    s.t. x_0 = xs,   x_{k+1} = A_k x_k + B_k u_k + c_k

A Levenberg term ``rho * I`` is added to each Quu — this is the per-lane
"rho" solver state mirroring the reference's ``resetRho`` semantics
(gato_controller.py:131-138) and keeps the sweep well-posed when the
Gauss-Newton position Hessian is rank-deficient.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .kkt import QPBlocks


class RiccatiSolution(NamedTuple):
    X: jnp.ndarray   # (N, nx)
    U: jnp.ndarray   # (N-1, nu)
    K: jnp.ndarray   # (N-1, nu, nx) feedback gains
    kff: jnp.ndarray  # (N-1, nu) feedforward


def _sym(M):
    return 0.5 * (M + jnp.swapaxes(M, -1, -2))


def backward_pass(blocks: QPBlocks, rho):
    """Backward Riccati recursion; returns gains (K, kff) per knot."""
    nu = blocks.B.shape[-1]
    eye_u = jnp.eye(nu, dtype=blocks.A.dtype)

    def step(carry, inp):
        S, s = carry
        A, B, c, Q, q, R, r = inp
        Sc = s + S @ c
        AtS = A.T @ S
        BtS = B.T @ S
        Qxx = Q + AtS @ A
        Quu = R + BtS @ B + rho * eye_u
        Qxu = AtS @ B
        qx = q + A.T @ Sc
        qu = r + B.T @ Sc

        # Pivoted LU rather than Cholesky: at N=64 the recursion drives
        # cond(Quu) past f32's range and a Cholesky pivot can go (float-)
        # negative, poisoning the whole lane with NaN; LU degrades to an
        # inaccurate step instead, which the merit line search simply
        # rejects (rho then escalates) — the same graceful-failure
        # behavior as the lane-major solver's sqrt-free LDL.
        Quu_s = _sym(Quu)
        K = -jnp.linalg.solve(Quu_s, Qxu.T)
        kff = -jnp.linalg.solve(Quu_s, qu)
        S_new = _sym(Qxx + Qxu @ K)
        s_new = qx + Qxu @ kff
        return (S_new, s_new), (K, kff)

    init = (blocks.Q[-1], blocks.q[-1])
    inputs = (
        blocks.A, blocks.B, blocks.c,
        blocks.Q[:-1], blocks.q[:-1], blocks.R, blocks.r,
    )
    (_, _), (K, kff) = jax.lax.scan(step, init, inputs, reverse=True)
    return K, kff


def forward_pass(blocks: QPBlocks, K, kff, xs):
    """Roll the affine policy forward from the pinned initial state."""

    def step(x, inp):
        A, B, c, Kk, kk = inp
        u = Kk @ x + kk
        x_next = A @ x + B @ u + c
        return x_next, (x, u)

    x_last, (X, U) = jax.lax.scan(
        step, xs, (blocks.A, blocks.B, blocks.c, K, kff)
    )
    X = jnp.concatenate([X, x_last[None]], axis=0)
    return X, U


def solve(blocks: QPBlocks, xs, rho) -> RiccatiSolution:
    """Exact solve of the block-tridiagonal QP for one lane.

    vmap over lanes for the batched solver; rho may be per-lane.

    When x64 is enabled (the tests), f32 inputs are upcast to f64 for the
    sweep and cast back: the backward recursion squares the conditioning
    per knot, and at N=64 with QN=100 the accumulated S reaches
    cond(Quu) ~ 1e11, past f32's ~1e7.  In float32 the sweep stays
    usable through the per-knot re-symmetrization of S and the pivoted
    LU on Quu: an inaccurate step is rejected by the merit line search
    instead of poisoning the lane with NaN.
    """
    dtype = blocks.A.dtype
    if dtype == jnp.float32 and jax.config.jax_enable_x64:
        blocks64 = jax.tree.map(lambda a: a.astype(jnp.float64), blocks)
        sol = solve(blocks64, xs.astype(jnp.float64),
                    jnp.asarray(rho, jnp.float64))
        return RiccatiSolution(*(a.astype(dtype) for a in sol))
    K, kff = backward_pass(blocks, rho)
    X, U = forward_pass(blocks, K, kff, xs)
    return RiccatiSolution(X=X, U=U, K=K, kff=kff)
