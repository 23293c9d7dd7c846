"""OSQP-style ADMM solve of the block-tridiagonal QP.

The reference's CPU path hands its KKT system to OSQP, an ADMM solver on
sparse CSC matrices (/root/reference/src/osqp_solver.py:39-41, 137-143).
This module is that *algorithm* re-designed for JAX: operator-splitting
ADMM on the same structured per-knot blocks every other backend consumes
(ops/kkt.py:QPBlocks) — no sparse matrices, no CSC, everything batched
dense block algebra that ``vmap``s over lanes.

QP solved (same as ops/riccati.py / ops/pcg.py):

    min  sum_k 0.5 x_k^T Q_k x_k + q_k^T x_k
         + sum_{k<N-1} 0.5 u_k^T (R_k + rho I) u_k + r_k^T u_k
    s.t. x_0 = xs,   x_{k+1} = A_k x_k + B_k u_k + c_k

In OSQP terms: decision variable z = (x_0,u_0,…,x_{N-1}) and constraint
set C = {b} (all rows are equalities, exactly like the reference's
``l == u`` dynamics rows, osqp_solver.py:54-68), so the projection step
is trivially ``b`` and the iteration reduces to

    H z~          = sigma z^k - g + A^T (rho_admm b - y^k)
    z^{k+1}       = alpha z~ + (1-alpha) z^k
    y^{k+1}       = y^k + rho_admm alpha (A z~ - b)

with ``H = P + sigma I + rho_admm A^T A`` — block tridiagonal in the
per-knot variable blocks ``zeta_k = [x_k; u_k]`` (the terminal knot's u
slots are padding held at zero by the sigma regularization).  H is
factored ONCE by a block-tridiagonal Cholesky and reused every iteration,
mirroring OSQP's factor-once / solve-many design; the factorization and
both substitution sweeps are ``lax.scan``s over the horizon, vmappable
over lanes.

Fixed penalty ``rho_admm`` (no adaptive rho): OSQP refactors its KKT on
rho updates, which would defeat the factor-once structure under jit; the
default matches OSQP's equality-constraint scaling (rho * 1e3).
Termination matches OSQP: eps_abs/eps_rel on the infinity norms of the
primal residual ``A z - b`` and dual residual ``P z + g + A^T y``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .kkt import QPBlocks


class ADMMSolution(NamedTuple):
    X: jnp.ndarray           # (N, nx)
    U: jnp.ndarray           # (N-1, nu)
    y: jnp.ndarray           # (N, nx) constraint multipliers
    iterations: jnp.ndarray  # () ADMM iterations used
    r_prim: jnp.ndarray      # () final ||A z - b||_inf
    r_dual: jnp.ndarray      # () final ||P z + g + A' y||_inf
    # Full interleaved primal iterate (N, nx+nu) — feed back as ``z0``
    # (with ``y`` as ``y0``) to warm-start the next related solve, the
    # OSQP object-reuse pattern (osqp_solver.py:137-143).
    z: Optional[jnp.ndarray] = None


def _blockdiag_P(blocks: QPBlocks, rho):
    """Per-knot P_k = blockdiag(Q_k, R_k + rho I) as (N, nz, nz)."""
    A, B, c, Q, q, R, r = blocks
    N, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[-1]
    nz = nx + nu
    dtype = Q.dtype
    P = jnp.zeros((N, nz, nz), dtype)
    P = P.at[:, :nx, :nx].set(0.5 * (Q + jnp.swapaxes(Q, -1, -2)))
    Reff = R + rho * jnp.eye(nu, dtype=dtype)
    P = P.at[:-1, nx:, nx:].set(0.5 * (Reff + jnp.swapaxes(Reff, -1, -2)))
    g = jnp.zeros((N, nz), dtype)
    g = g.at[:, :nx].set(q)
    g = g.at[:-1, nx:].set(r)
    return P, g


def _constraint_apply(blocks: QPBlocks, z):
    """A z: row 0 = x_0; row k+1 = A_k x_k + B_k u_k - x_{k+1}."""
    A, B, _, Q, _, R, _ = blocks
    nx, nu = Q.shape[1], R.shape[-1]
    x = z[:, :nx]
    u = z[:-1, nx:]
    dyn = (
        jnp.einsum("kij,kj->ki", A, x[:-1])
        + jnp.einsum("kij,kj->ki", B, u)
        - x[1:]
    )
    return jnp.concatenate([x[:1], dyn], axis=0)


def _constraint_adjoint(blocks: QPBlocks, w):
    """A^T w for w (N, nx), returned as (N, nz)."""
    A, B, _, Q, _, R, _ = blocks
    N, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[-1]
    nz = nx + nu
    out = jnp.zeros((N, nz), w.dtype)
    out = out.at[0, :nx].add(w[0])                       # initial-state row
    wd = w[1:]                                            # (N-1, nx)
    out = out.at[:-1, :nx].add(jnp.einsum("kji,kj->ki", A, wd))
    out = out.at[:-1, nx:].add(jnp.einsum("kji,kj->ki", B, wd))
    out = out.at[1:, :nx].add(-wd)
    return out


def _build_H(blocks: QPBlocks, rho, sigma, rho_admm):
    """H = P + sigma I + rho_admm A^T A as block-tridiagonal (D, E).

    D: (N, nz, nz) diagonal blocks; E: (N-1, nz, nz) upper couplings
    ``H[k, k+1]``.
    """
    A, B, c, Q, q, R, r = blocks
    N, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[-1]
    nz = nx + nu
    dtype = Q.dtype

    P, _ = _blockdiag_P(blocks, rho)
    D = P + sigma * jnp.eye(nz, dtype=dtype)

    # Selector diag(I_nx, 0): row 0 hits z_0, row k+1 hits z_{k+1}.
    sel = jnp.zeros((nz, nz), dtype).at[:nx, :nx].set(jnp.eye(nx, dtype=dtype))
    D = D.at[0].add(rho_admm * sel)
    D = D.at[1:].add(rho_admm * sel)

    # G_k = [A_k B_k]: D_k += rho G_k' G_k for k < N-1.
    G = jnp.concatenate([A, B], axis=-1)                  # (N-1, nx, nz)
    D = D.at[:-1].add(rho_admm * jnp.einsum("kai,kaj->kij", G, G))

    # E_k = rho G_k' F, F = [-I 0]  =>  E_k = -rho [A_k B_k]' on x-columns.
    E = jnp.zeros((N - 1, nz, nz), dtype)
    E = E.at[:, :, :nx].set(-rho_admm * jnp.swapaxes(G, -1, -2))
    return D, E


def _factor(D, E):
    """Block-tridiagonal Cholesky: H = L L^T.

    Returns (Ls (N, nz, nz) lower-triangular diagonal factors,
    Ws (N-1, nz, nz) with W_k = L_k^{-1} E_k, so L[k+1,k] = W_k^T).
    """
    solve_tri = jax.scipy.linalg.solve_triangular

    def step(S, E_k):
        L = jnp.linalg.cholesky(S)
        W = solve_tri(L, E_k, lower=True)
        return W, L

    # First block factors directly; then scan the Schur updates.
    L0 = jnp.linalg.cholesky(D[0])
    W0 = solve_tri(L0, E[0], lower=True)

    def scan_step(carry, inp):
        W_prev = carry
        D_k, E_k = inp
        S = D_k - W_prev.T @ W_prev
        L = jnp.linalg.cholesky(S)
        W = solve_tri(L, E_k, lower=True)
        return W, (L, W_prev)

    # Pad E with a zero block so every knot has an "outgoing" coupling.
    nz = D.shape[-1]
    E_pad = jnp.concatenate([E[1:], jnp.zeros((1, nz, nz), D.dtype)], axis=0)
    _, (Ls_rest, Ws_prev) = jax.lax.scan(scan_step, W0, (D[1:], E_pad))
    Ls = jnp.concatenate([L0[None], Ls_rest], axis=0)     # (N, nz, nz)
    Ws = jnp.concatenate([W0[None], Ws_prev[1:]], axis=0)  # (N-1, nz, nz)
    return Ls, Ws


def _solve_factored(Ls, Ws, rhs):
    """Solve H xi = rhs given the block Cholesky factors."""
    solve_tri = jax.scipy.linalg.solve_triangular

    # Forward: v_0 = L_0^{-1} rhs_0; v_{k+1} = L_{k+1}^{-1}(rhs_{k+1} - W_k' v_k)
    v0 = solve_tri(Ls[0], rhs[0], lower=True)

    def fwd(v_prev, inp):
        L, W_prev, b = inp
        v = solve_tri(L, b - W_prev.T @ v_prev, lower=True)
        return v, v

    _, v_rest = jax.lax.scan(fwd, v0, (Ls[1:], Ws, rhs[1:]))
    v = jnp.concatenate([v0[None], v_rest], axis=0)

    # Backward: xi_{N-1} = L^{-T} v; xi_k = L_k^{-T}(v_k - W_k xi_{k+1}).
    xT = solve_tri(Ls[-1], v[-1], lower=True, trans="T")

    def bwd(x_next, inp):
        L, W, vk = inp
        x = solve_tri(L, vk - W @ x_next, lower=True, trans="T")
        return x, x

    _, x_rest = jax.lax.scan(
        bwd, xT, (Ls[:-1], Ws, v[:-1]), reverse=True
    )
    return jnp.concatenate([x_rest, xT[None]], axis=0)


def solve(
    blocks: QPBlocks,
    xs,
    rho,
    sigma: float = 1e-6,
    rho_admm: float = 1e3,
    alpha: float = 1.6,
    eps_abs: float = 1e-6,
    eps_rel: float = 1e-6,
    max_iters: int = 400,
    z0: Optional[jnp.ndarray] = None,
    y0: Optional[jnp.ndarray] = None,
) -> ADMMSolution:
    """OSQP-algorithm ADMM solve of the block-tridiagonal QP (one lane).

    ``xs``: pinned initial state (or initial-state delta under the GN
    formulation).  ``z0``/``y0`` warm-start the primal interleaved
    trajectory and the constraint multipliers (OSQP's warm-start surface,
    osqp_solver.py:137-143 reuses the solver object across SQP
    iterations).  vmap over lanes for the batched solver.
    """
    A, B, c, Q, q, R, r = blocks
    N, nx = Q.shape[0], Q.shape[1]
    nu = R.shape[-1]
    nz = nx + nu
    dtype = Q.dtype
    m_rows = N * nx
    n_vars = N * nz

    P, g = _blockdiag_P(blocks, rho)
    D, E = _build_H(blocks, rho, sigma, rho_admm)
    Ls, Ws = _factor(D, E)

    b = jnp.concatenate([xs[None], -c], axis=0)           # (N, nx)

    z = jnp.zeros((N, nz), dtype) if z0 is None else z0
    y = jnp.zeros((N, nx), dtype) if y0 is None else y0

    Atb = _constraint_adjoint(blocks, rho_admm * b)

    def residuals(z, y):
        rp = jnp.max(jnp.abs(_constraint_apply(blocks, z) - b))
        Pz = jnp.einsum("kij,kj->ki", P, z)
        rd = jnp.max(jnp.abs(Pz + g + _constraint_adjoint(blocks, y)))
        return rp, rd

    def tolerances(z, y):
        Az = _constraint_apply(blocks, z)
        Pz = jnp.einsum("kij,kj->ki", P, z)
        Aty = _constraint_adjoint(blocks, y)
        eps_p = eps_abs * jnp.sqrt(float(m_rows)) + eps_rel * jnp.maximum(
            jnp.max(jnp.abs(Az)), jnp.max(jnp.abs(b))
        )
        eps_d = eps_abs * jnp.sqrt(float(n_vars)) + eps_rel * jnp.maximum(
            jnp.maximum(jnp.max(jnp.abs(Pz)), jnp.max(jnp.abs(Aty))),
            jnp.max(jnp.abs(g)),
        )
        return eps_p, eps_d

    def cond(state):
        z, y, it = state
        rp, rd = residuals(z, y)
        eps_p, eps_d = tolerances(z, y)
        converged = jnp.logical_and(rp <= eps_p, rd <= eps_d)
        return jnp.logical_and(it < max_iters, ~converged)

    def body(state):
        z, y, it = state
        rhs = sigma * z - g + Atb - _constraint_adjoint(blocks, y)
        zt = _solve_factored(Ls, Ws, rhs)
        z_new = alpha * zt + (1.0 - alpha) * z
        y_new = y + rho_admm * alpha * (_constraint_apply(blocks, zt) - b)
        return z_new, y_new, it + 1

    z, y, iters = jax.lax.while_loop(
        cond, body, (z, y, jnp.asarray(0, jnp.int32))
    )
    rp, rd = residuals(z, y)
    return ADMMSolution(
        X=z[:, :nx],
        U=z[:-1, nx:],
        y=y,
        iterations=iters,
        r_prim=rp.astype(dtype),
        r_dual=rd.astype(dtype),
        z=z,
    )
