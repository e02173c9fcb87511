"""Via-point optimization on device.

Replaces the reference's qpOASES via QP and Ipopt via-rotation NLP
(`bound_planner/utils/optimization_functions.py:186-387`) with the generic
Gauss-Newton SQP (`ops.sqp`).

Re-design note: the reference enforces EE-tip containment along each
segment through per-face interior-maximizer root constraints
(`optimization_functions.py:274-363`: a stationarity equality gated by a
sign test, one auxiliary variable per face). Here we instead constrain
the tip at a fixed fan of interpolation samples per segment — same intent
(tip stays inside the via set during the blended motion), fixed shapes, no
gated equalities; the reference itself samples omega the same way in its
fit checks (`BoundPlanner.py:745-772`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.sqp import gauss_newton_sqp
from ..ops.qp import solve_feasibility
from ..utils import so3

N_SEG_SAMPLES = 7  # interior samples per segment for tip containment


def _tip(omega_normed, omega_norm, w, l_ee):
    return so3.rodrigues(omega_normed, omega_norm * w) @ l_ee


@functools.partial(jax.jit, static_argnames=("nr_via",))
def solve_via_rot(
    x0,
    p_start,
    p_end,
    l_ee,
    omega_normed,
    omega_norm,
    w_size_via,     # (nr_via + 1,)
    a_inter,        # (nr_via, R, 3)
    b_inter,        # (nr_via, R)
    a_via,          # (nr_via + 1, R, 3)
    b_via,          # (nr_via + 1, R)
    nr_via: int,
):
    """Optimize via points + rotation interpolation fractions.

    x layout: [p_1 (3), w_1, p_2 (3), w_2, ...] (4 * nr_via), matching the
    reference solution layout (`BoundPlanner.py:696-699`).
    Returns the SQPResult.
    """
    dtype = p_start.dtype
    samples = jnp.linspace(0.0, 1.0, N_SEG_SAMPLES + 2, dtype=dtype)[1:-1]

    def unpack(x):
        blocks = x.reshape(nr_via, 4)
        return blocks[:, :3], blocks[:, 3]

    def residuals(x):
        p, w = unpack(x)
        p_all = jnp.concatenate([p_start[None], p, p_end[None]], axis=0)
        w_all = jnp.concatenate(
            [jnp.zeros(1, dtype), w, jnp.ones(1, dtype)]
        )
        dp = p_all[1:] - p_all[:-1]          # (nr_via+1, 3)
        dw = w_all[1:] - w_all[:-1]
        sw = jnp.sqrt(w_size_via)
        return jnp.concatenate([(sw[:, None] * dp).reshape(-1), sw * dw])

    def cons(x):
        p, w = unpack(x)
        p_all = jnp.concatenate([p_start[None], p, p_end[None]], axis=0)
        w_all = jnp.concatenate([jnp.zeros(1, dtype), w, jnp.ones(1, dtype)])
        rows = []
        # via point and its EE tip inside the intersection set
        # (ref `optimization_functions.py:270-272,365-367`)
        for i in range(nr_via):
            tip = _tip(omega_normed, omega_norm, w[i], l_ee)
            rows.append(a_inter[i] @ p[i] - b_inter[i])
            rows.append(a_inter[i] @ (p[i] + tip) - b_inter[i])
        # tip containment along each segment in its via set (sampled fan)
        for i in range(nr_via + 1):
            def seg_rows(phi):
                pm = p_all[i] + phi * (p_all[i + 1] - p_all[i])
                wm = w_all[i] + phi * (w_all[i + 1] - w_all[i])
                tip = _tip(omega_normed, omega_norm, wm, l_ee)
                return a_via[i] @ (pm + tip) - b_via[i]

            rows.append(jax.vmap(seg_rows)(samples).reshape(-1))
        # 0 <= w <= 1
        rows.append(-w)
        rows.append(w - 1.0)
        return jnp.concatenate(rows)

    return gauss_newton_sqp(
        lambda x: (residuals(x), cons(x)), x0, iters=25, qp_iters=30,
        line_search_steps=8, merit_penalty=1e3, viol_tol=1e-5,
    )


@jax.jit
def fit_ee_in_set(a_set, b_set, l_ee, omega_normed, omega_norm, sample_point):
    """Does the EE segment fit into the set for some of 20 sampled rotation
    fractions? (ref `check_intersection`, `BoundPlanner.py:745-772`.)

    a_set: (R, 3), b_set: (R,) — already shrunk by the caller.
    Returns (fits (bool), omega (first feasible fraction), p (its point))."""
    dtype = b_set.dtype
    omegas = jnp.linspace(0.0, 1.0, 20, dtype=dtype)

    def one(w):
        tip = _tip(omega_normed, omega_norm, w, l_ee)
        g = jnp.concatenate([a_set, a_set], axis=0)
        h = jnp.concatenate([b_set, b_set - a_set @ tip])
        x, t, _ = solve_feasibility(g, h, x0=sample_point, iters=25)
        return t < 1e-7, x

    ok, xs = jax.vmap(one)(omegas)
    fits = jnp.any(ok)
    first = jnp.argmax(ok)
    return fits, jnp.where(fits, omegas[first], 0.0), xs[first]
