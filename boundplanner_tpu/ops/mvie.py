"""Batched maximum-volume-inscribed-ellipsoid (MVIE) solver.

Replaces the reference's three CLARABEL SOCPs
(`BoundPlanner/ConvexSetFinder.py:512-680`): free ellipsoid, fixed-center,
and fixed-orientation variants. The problem

    maximize    log det L
    subject to  ||L^T a_i|| + a_i^T d <= b_i      (ellipsoid {d + L u, |u|<=1}
                                                   inside every half-space)

is solved with a log-barrier damped-Newton path-following method over the
9 free parameters (6 lower-triangular entries of L + 3 center coords) —
tiny, smooth, fully ``vmap``-able, no conic machinery needed. The
``-log det L`` term doubles as the barrier for the positive diagonal.

Inactive padded rows (b >> 0) are harmless: their barrier terms are flat.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# numpy (not jnp): module-level device arrays would initialize the JAX
# backend at import time, before a spawned CPU-only fleet planning worker
# can select its platform
_TRI_ROWS = np.array([0, 1, 1, 2, 2, 2])
_TRI_COLS = np.array([0, 0, 1, 0, 1, 2])
_DIAG_IDX = np.array([0, 2, 5])


def _tri_to_mat(tri):
    return jnp.zeros((3, 3), tri.dtype).at[_TRI_ROWS, _TRI_COLS].set(tri)


class MVIEResult(NamedTuple):
    shape: jax.Array    # S = L L^T, (3,3) — the reference's ``q_inv``
    center: jax.Array   # d, (3,)
    gen: jax.Array      # L lower-triangular generator, (3,3)
    ok: jax.Array       # bool: finite and positive-definite


def _margins(l_mat, d, a_mat, b_vec, mode_fixed_r, r_mat):
    if mode_fixed_r:
        gen = r_mat @ jnp.diag(l_mat)  # l_mat holds the 3 axis scalings
    else:
        gen = l_mat
    at = a_mat @ gen  # (m, 3) rows a_i^T L
    norms = jnp.sqrt(jnp.sum(at * at, axis=1) + 1e-14)
    return b_vec - a_mat @ d - norms


def _solve_barrier(theta0, objective, n_free, stages, newton_steps):
    """Damped Newton on  f(theta) = obj(theta, mu)  along a mu-schedule."""

    def newton(theta, mu):
        def one(theta, _):
            g = jax.grad(objective)(theta, mu)
            h = jax.hessian(objective)(theta, mu)
            h = h + 1e-9 * jnp.eye(n_free, dtype=theta.dtype)
            step = jnp.linalg.solve(h, g)
            f0 = objective(theta, mu)

            # backtracking: pick the best feasible decrease among fixed trials
            alphas = 2.0 ** -jnp.arange(8, dtype=theta.dtype)
            cand = theta[None, :] - alphas[:, None] * step[None, :]
            fvals = jax.vmap(lambda t: objective(t, mu))(cand)
            fvals = jnp.where(jnp.isfinite(fvals), fvals, jnp.inf)
            best = jnp.argmin(fvals)
            theta_new = cand[best]
            improved = fvals[best] < f0
            return jnp.where(improved, theta_new, theta), None

        theta, _ = jax.lax.scan(one, theta, None, length=newton_steps)
        return theta

    def stage(theta, mu):
        return newton(theta, mu), None

    mus = 10.0 ** -jnp.arange(1, stages + 1, dtype=theta0.dtype)
    theta, _ = jax.lax.scan(stage, theta0, mus)
    return theta


def _chebyshev_center(a_mat, b_vec, radius: float = 10.0):
    """Deepest point of {Ax<=b} (rows assumed ~normalized): phase-1 QP
    initialization. A +-radius box is appended so the search stays bounded
    even for degenerate/unbounded inputs (the planner's sets always carry
    workspace rows, ref `ConvexSetFinder.py:377-398`, but per-tick link sets
    may not)."""
    from .qp import solve_feasibility

    dtype = b_vec.dtype
    box_a = jnp.concatenate([jnp.eye(3, dtype=dtype), -jnp.eye(3, dtype=dtype)])
    box_b = jnp.full((6,), radius, dtype)
    a_ext = jnp.concatenate([a_mat, box_a], axis=0)
    b_ext = jnp.concatenate([b_vec, box_b])
    x, t, _ = solve_feasibility(a_ext, b_ext)
    # margin w.r.t. the true rows only
    margin = jnp.min(b_vec - a_mat @ x)
    return x, margin


@functools.partial(jax.jit, static_argnames=("stages", "newton_steps"))
def mvie(a_mat, b_vec, d0=None, stages: int = 7, newton_steps: int = 6) -> MVIEResult:
    """Free MVIE (ref `ConvexSetFinder.py:512-537` / `cvx_mvie_socp`)."""
    dtype = b_vec.dtype
    if d0 is None:
        d0, margin0 = _chebyshev_center(a_mat, b_vec)
    else:
        margin0 = jnp.min(_margins(jnp.zeros((3, 3), dtype), d0, a_mat, b_vec, False, None))
    # Containment invariant (ref `ConvexSetFinder.py:433-438` raises on
    # violation): an infeasible seed must not return ok=True. The clamp
    # below only keeps the barrier numerically defined.
    seed_ok = margin0 > 0
    margin0 = jnp.maximum(margin0, 1e-6)
    row_norm = jnp.maximum(jnp.max(jnp.linalg.norm(a_mat, axis=1)), 1e-9)
    eps0 = 0.5 * margin0 / row_norm

    tri0 = jnp.zeros(6, dtype).at[_DIAG_IDX].set(eps0)
    theta0 = jnp.concatenate([tri0, d0])

    def objective(theta, mu):
        l_mat = _tri_to_mat(theta[:6])
        d = theta[6:]
        m = _margins(l_mat, d, a_mat, b_vec, False, None)
        diag = theta[_DIAG_IDX]
        return -jnp.sum(jnp.log(jnp.maximum(diag, 1e-300))) - mu * jnp.sum(
            jnp.log(jnp.maximum(m, 1e-300))
        )

    theta = _solve_barrier(theta0, objective, 9, stages, newton_steps)
    l_mat = _tri_to_mat(theta[:6])
    d = theta[6:]
    shape = l_mat @ l_mat.T
    ok = seed_ok & jnp.all(jnp.isfinite(theta)) & jnp.all(theta[_DIAG_IDX] > 0)
    return MVIEResult(shape=shape, center=d, gen=l_mat, ok=ok)


@functools.partial(jax.jit, static_argnames=("stages", "newton_steps"))
def mvie_fixed_mid(a_mat, b_vec, d_fixed, stages: int = 7, newton_steps: int = 6) -> MVIEResult:
    """MVIE with fixed center (ref `ConvexSetFinder.py:539-562`)."""
    dtype = b_vec.dtype
    margin0 = jnp.min(b_vec - a_mat @ d_fixed)
    seed_ok = margin0 > 0  # containment invariant, see `mvie`
    margin0 = jnp.maximum(margin0, 1e-6)
    row_norm = jnp.maximum(jnp.max(jnp.linalg.norm(a_mat, axis=1)), 1e-9)
    eps0 = 0.5 * margin0 / row_norm
    theta0 = jnp.zeros(6, dtype).at[_DIAG_IDX].set(eps0)

    def objective(theta, mu):
        l_mat = _tri_to_mat(theta)
        m = _margins(l_mat, d_fixed, a_mat, b_vec, False, None)
        diag = theta[_DIAG_IDX]
        return -jnp.sum(jnp.log(jnp.maximum(diag, 1e-300))) - mu * jnp.sum(
            jnp.log(jnp.maximum(m, 1e-300))
        )

    theta = _solve_barrier(theta0, objective, 6, stages, newton_steps)
    l_mat = _tri_to_mat(theta)
    shape = l_mat @ l_mat.T
    ok = seed_ok & jnp.all(jnp.isfinite(theta)) & jnp.all(theta[_DIAG_IDX] > 0)
    return MVIEResult(shape=shape, center=d_fixed, gen=l_mat, ok=ok)


@functools.partial(jax.jit, static_argnames=("stages", "newton_steps"))
def mvie_fixed_r(
    a_mat, b_vec, d_fixed, r_mat, axis0_lb, stages: int = 7, newton_steps: int = 6
) -> MVIEResult:
    """MVIE with fixed center and orientation: L = R diag(e), e_0 >= axis0_lb
    (ref `ConvexSetFinder.py:564-588`). The lower bound on the first axis is
    enforced with its own barrier term."""
    dtype = b_vec.dtype
    margin0 = jnp.min(b_vec - a_mat @ d_fixed)
    seed_ok = margin0 > 0  # containment invariant, see `mvie`
    margin0 = jnp.maximum(margin0, 1e-6)
    row_norm = jnp.maximum(jnp.max(jnp.linalg.norm(a_mat, axis=1)), 1e-9)
    eps0 = 0.5 * margin0 / row_norm
    e0 = jnp.full((3,), eps0, dtype).at[0].set(jnp.maximum(eps0, axis0_lb * 1.001))

    def objective(theta, mu):
        m = _margins(theta, d_fixed, a_mat, b_vec, True, r_mat)
        lb_margin = theta[0] - axis0_lb
        return (
            -jnp.sum(jnp.log(jnp.maximum(theta, 1e-300)))
            - mu * jnp.sum(jnp.log(jnp.maximum(m, 1e-300)))
            - mu * jnp.log(jnp.maximum(lb_margin, 1e-300))
        )

    theta = _solve_barrier(e0, objective, 3, stages, newton_steps)
    l_mat = r_mat @ jnp.diag(theta)
    shape = l_mat @ l_mat.T
    ok = seed_ok & jnp.all(jnp.isfinite(theta)) & jnp.all(theta > 0)
    return MVIEResult(shape=shape, center=d_fixed, gen=l_mat, ok=ok)
