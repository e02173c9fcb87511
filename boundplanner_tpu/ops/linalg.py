"""Dense linear algebra for the batched QP solvers.

``kkt_inverse`` is the factorization every interior-point iteration runs:
XLA's batched Cholesky plus a triangular solve against the identity (on
the GPU these lower to cuSOLVER/cuBLAS batched routines). The masked
column-loop forms below (`cholesky_masked`, `invert_lower`) are the
plain reference it is tested against: a fixed-trip loop of masked
vector/outer-product updates, no library calls.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def cholesky_masked(a):
    """Lower-triangular Cholesky factor of SPD ``a`` (n, n), column-loop
    form. vmap-friendly; no custom-calls."""
    n = a.shape[0]
    idx = jnp.arange(n)

    def body(j, aa):
        d = jnp.sqrt(jnp.maximum(aa[j, j], 1e-30))
        col_below = jnp.where(idx > j, aa[:, j] / d, 0.0)
        aa = aa - jnp.outer(col_below, col_below)
        new_col = col_below.at[j].set(d)
        aa = aa.at[:, j].set(jnp.where(idx >= j, new_col, aa[:, j]))
        return aa

    l = jax.lax.fori_loop(0, n, body, a)
    return jnp.tril(l)


def solve_lower(l, b):
    """Solve L y = b with L lower-triangular, forward substitution as a
    fixed-trip loop of masked dot products."""
    n = b.shape[0]
    idx = jnp.arange(n)

    def body(j, y):
        mask = (idx < j).astype(b.dtype)
        s = jnp.dot(l[j] * mask, y)
        return y.at[j].set((b[j] - s) / l[j, j])

    return jax.lax.fori_loop(0, n, body, jnp.zeros_like(b))


def solve_upper_t(l, b):
    """Solve L^T x = b (back substitution over the lower factor)."""
    n = b.shape[0]
    idx = jnp.arange(n)

    def body(k, x):
        j = n - 1 - k
        mask = (idx > j).astype(b.dtype)
        s = jnp.dot(l[:, j] * mask, x)
        return x.at[j].set((b[j] - s) / l[j, j])

    return jax.lax.fori_loop(0, n, body, jnp.zeros_like(b))


def invert_lower(l):
    """Explicit inverse of a lower-triangular matrix, row-loop form.

    Each of the n steps is a masked (n,)x(n,n) matvec — n sequential steps
    total (vs n per *solve*), after which every solve with this factor is
    two matvecs. Worth it whenever the factor is reused (the IPM does
    4 triangular solves per factorization)."""
    n = l.shape[0]
    idx = jnp.arange(n)
    eye = jnp.eye(n, dtype=l.dtype)

    def body(j, x):
        mask = (idx < j).astype(l.dtype)
        row = (eye[j] - (l[j] * mask) @ x) / l[j, j]
        return x.at[j].set(row)

    return jax.lax.fori_loop(0, n, body, jnp.zeros_like(l))


def chol_solve(l, b):
    """Solve (L L^T) x = b given the factor."""
    return solve_upper_t(l, solve_lower(l, b))


def spd_solve(a, b):
    """Solve SPD system a x = b via the masked Cholesky."""
    return chol_solve(cholesky_masked(a), b)


def kkt_inverse(kkt):
    """L^{-1} for the Cholesky factor L of an SPD KKT matrix (n, n).

    The IPM applies K^{-1} = L^{-T} L^{-1} as two matvecs, so the inverse
    factor, not L itself, is what each iteration needs. ``vmap`` batches
    both library calls natively."""
    n = kkt.shape[-1]
    with jax.named_scope("kkt_inverse"):
        l = jnp.linalg.cholesky(kkt)
        eye = jnp.broadcast_to(jnp.eye(n, dtype=kkt.dtype), kkt.shape)
        l_inv = jax.lax.linalg.triangular_solve(l, eye, left_side=True,
                                                lower=True)
        return jnp.tril(l_inv)
