#!/usr/bin/env python
"""A/B the two exact QP backends at the production shape (r05 horizon-
parallel experiment, VERDICT r4 #5).

Times the readable vmap solver's QP step with qp_backend="riccati"
(sequential O(N) sweep) vs "riccati_pscan" (associative-scan backward
pass, O(log N) depth) on the SAME random KKT blocks, B lanes, chained
on device.  This isolates the backward-pass formulation cost at the
XLA level (ROADMAP: decide the horizon-parallel Riccati on the GPU).

Usage: python tools/profile_pscan.py [B] [N]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("N", nargs="?", type=int, default=64)
    args = ap.parse_args()

    from indy7_mpc.utils.cache import enable_cache

    enable_cache()
    from indy7_mpc.ops import riccati, riccati_pscan
    from indy7_mpc.ops.kkt import QPBlocks

    B, N = args.B, args.N
    nx, nu = 12, 6
    rng = np.random.default_rng(0)
    dtype = jnp.float32

    def blocks_one(_):
        A = rng.normal(size=(N - 1, nx, nx)) * 0.1 + np.eye(nx)
        Bm = rng.normal(size=(N - 1, nx, nu)) * 0.1
        c = rng.normal(size=(N - 1, nx)) * 0.01
        Qh = rng.normal(size=(N, nx, nx)) * 0.1
        Q = Qh @ Qh.transpose(0, 2, 1) + 0.1 * np.eye(nx)
        q = rng.normal(size=(N, nx)) * 0.1
        Rh = rng.normal(size=(N - 1, nu, nu)) * 0.1
        R = Rh @ Rh.transpose(0, 2, 1) + 0.5 * np.eye(nu)
        r = rng.normal(size=(N - 1, nu)) * 0.1
        return QPBlocks(*[jnp.asarray(x, dtype)
                          for x in (A, Bm, c, Q, q, R, r)])

    blocks = jax.tree.map(
        lambda *xs: jnp.stack(xs), *[blocks_one(i) for i in range(B)]
    )
    xs0 = jnp.asarray(rng.normal(size=(B, nx)) * 0.1, dtype)
    rho = jnp.full((B,), 1e-6, dtype)

    kind = jax.devices()[0].device_kind
    R = 50
    print(f"# device={kind} B={B} N={N} (batched exact QP solve, "
          f"{R}-chain, blocking dispatches)")
    for name, fn in (
        ("riccati (sequential)", riccati.solve),
        ("riccati_pscan (assoc-scan)", riccati_pscan.solve_pscan),
    ):
        solve_b = jax.vmap(lambda b, x, r: fn(b, x, r))

        @jax.jit
        def chained(blocks, xs0, rho):
            def body(_, x):
                # Perturb A by the carried state so the BACKWARD pass
                # (the thing under test) depends on the loop iteration —
                # otherwise XLA hoists the loop-invariant factorizations
                # out of the chain and the timing only sees the forward
                # rollout.
                b = blocks._replace(
                    A=blocks.A + 1e-9 * x[:, None, :, None]
                )
                sol = solve_b(b, x, rho)
                return sol.X[:, 0] * 1e-6 + xs0  # data-dep chain
            return jax.lax.fori_loop(0, R, body, xs0)

        # Null chain: same dispatch/loop structure without the solve —
        # subtracting it isolates the solve's device time from the
        # dispatch overhead.
        @jax.jit
        def null_chain(blocks, xs0, rho):
            def body(_, x):
                return x * (1.0 - 1e-12) + 1e-12 * xs0
            return jax.lax.fori_loop(0, R, body, xs0)

        out = chained(blocks, xs0, rho)
        jax.block_until_ready(out)
        outn = null_chain(blocks, xs0, rho)
        jax.block_until_ready(outn)
        reps = 5
        t0 = time.perf_counter()
        for _ in range(reps):
            out = chained(blocks, xs0, rho)
            jax.block_until_ready(out)
        t_full = (time.perf_counter() - t0) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            outn = null_chain(blocks, xs0, rho)
            jax.block_until_ready(outn)
        t_null = (time.perf_counter() - t0) / reps
        t = (t_full - t_null) / R
        print(f"{name:<28} {t * 1e6:8.0f} us per batched QP solve "
              f"(chain {t_full*1e3:.1f} ms, null {t_null*1e3:.1f} ms, "
              f"|out| {float(jnp.abs(out).mean()):.3e})")


if __name__ == "__main__":
    main()
