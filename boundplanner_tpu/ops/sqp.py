"""Generic batched Gauss-Newton SQP over the dense QP-IPM.

One nonlinear-programming engine for every NLP in the system — the role
Ipopt plays in the reference (`casadi_ocp_formulation.py:418`,
`optimization_functions.py:385`, `RobotModel.py:130`):

- the condensed BoundMPC tracking OCP (``mpc.solver``)
- the planner's via-point rotation NLP (``planner.via_opt``)

Problem form:  min  |r(x)|^2   s.t.  g(x) <= 0, supplied as ONE joint
``eval_fn(x) -> (r, g)`` so the (usually shared) underlying model — e.g.
the trajectory rollout — is built and differentiated once. B = 2 J_r^T J_r
is the true curvature of the quadratic objective. Fixed-trip iteration
with masked convergence keeps vmapped batches in lockstep.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .qp import solve_qp, solve_qp_admm


class SQPResult(NamedTuple):
    x: jax.Array
    cost: jax.Array
    viol: jax.Array
    iters: jax.Array
    success: jax.Array


def gauss_newton_sqp(
    eval_fn: Callable,
    x0: jax.Array,
    iters: int = 12,
    qp_iters: int = 25,
    line_search_steps: int = 6,
    merit_penalty: float = 1e3,
    viol_tol: float = 1e-4,
    qp_solver: str = "ipm",
    admm_iters: int = 60,
    eval_jac_fn=None,
    qp_lowp: bool = False,
    kkt_every: int = 1,
    struct=None,
    qp_gondzio: int = 0,
    link_a=None,
    qp_warm_dual: bool = False,
    qp_lowp_rd: bool = False,
    qp_warm_sz: bool = False,
) -> SQPResult:
    """``eval_jac_fn`` (optional): x -> (r, g, Jr, Jg) with values identical
    to ``eval_fn`` — a manual/structured Jacobian path (e.g.
    `mpc.ocp_jac.evaluate_with_jac`). Defaults to ``jacfwd(eval_fn)``.

    ``struct`` (optional, requires a matching ``eval_jac_fn`` such as
    `mpc.ocp_jac.evaluate_with_jac_structured`): the block-banded OCP
    structure (`mpc.ocp_struct.OCPStruct`). The eval's Jg then covers only
    the first ``struct.m_run`` constraint rows; the static bound/slack
    tail is applied structurally inside the QP, and the Gauss-Newton
    Hessian/Gram products use the causal chunk split. With ``link_a``
    (the per-scene link-set matrices), ``eval_jac_fn`` returns
    (r, g, Jr, Jg_dense, acol_u) and the 1260 link rows are applied
    through their factorization (`OCPStruct.link_*`) instead of a dense
    block — row order [dense | link | tail]."""
    nu = jnp.asarray(merit_penalty, x0.dtype)
    n_x = x0.shape[0]
    eye = jnp.eye(n_x, dtype=x0.dtype)

    jac_fn = jax.jacfwd(eval_fn)
    alphas = 2.0 ** -jnp.arange(line_search_steps, dtype=x0.dtype)

    def merit_of(r, g):
        return jnp.sum(r * r) + nu * jnp.sum(jnp.maximum(g, 0.0))

    def body(it, carry):
        if qp_warm_dual:
            x, lam, merit_prev, done, used, r_cur, g_cur, z_prev = carry
        else:
            x, lam, merit_prev, done, used, r_cur, g_cur = carry
            z_prev = None

        acol_u = None
        if eval_jac_fn is not None:
            if link_a is not None:
                r, g, jr, jg, acol_u = eval_jac_fn(x)
            else:
                r, g, jr, jg = eval_jac_fn(x)
        else:
            r, g = eval_fn(x)
            jr, jg = jac_fn(x)

        grad = 2.0 * jr.T @ r
        if struct is not None:
            hess = 2.0 * struct.gram_r(jr) + lam * eye
        else:
            hess = 2.0 * jr.T @ jr + lam * eye

        if qp_solver == "admm":
            qp = solve_qp_admm(hess, grad, jg, -g, iters=admm_iters)
        elif struct is not None and link_a is not None:
            md, ml = struct.m_dense, struct.m_link
            qp = solve_qp(hess, grad, jg, -g[:md], iters=qp_iters,
                          tol=1e-10, lowp=qp_lowp,
                          kkt_every=kkt_every, struct=struct,
                          h_tail=-g[md + ml:], gondzio=qp_gondzio,
                          link=(acol_u, link_a), h_link=-g[md : md + ml],
                          z0=z_prev, lowp_rd=qp_lowp_rd,
                          warm_sz=qp_warm_sz)
        elif struct is not None:
            m_run = struct.m_run
            qp = solve_qp(hess, grad, jg, -g[:m_run], iters=qp_iters,
                          tol=1e-10, lowp=qp_lowp,
                          kkt_every=kkt_every, struct=struct,
                          h_tail=-g[m_run:], gondzio=qp_gondzio,
                          z0=z_prev, lowp_rd=qp_lowp_rd,
                          warm_sz=qp_warm_sz)
        else:
            qp = solve_qp(hess, grad, jg, -g, iters=qp_iters, tol=1e-10,
                          lowp=qp_lowp,
                          kkt_every=kkt_every, gondzio=qp_gondzio,
                          z0=z_prev, lowp_rd=qp_lowp_rd,
                          warm_sz=qp_warm_sz)
        d = qp.x

        cand = x[None, :] + alphas[:, None] * d[None, :]
        r_c, g_c = jax.vmap(eval_fn)(cand)
        merits = jax.vmap(merit_of)(r_c, g_c)
        merits = jnp.where(jnp.isfinite(merits), merits, jnp.inf)
        # tie-break toward the LARGEST step: among candidates within a
        # relative band of the best merit, take the first (alphas are
        # ordered descending). A bare argmin flips on f32 noise when two
        # candidates near-tie, making marginal scenes' closed-loop fate
        # depend on batch-width codegen (observed); the band makes the
        # choice deterministic and favors progress.
        m_min = jnp.min(merits)
        tol = 1e-5 * jnp.abs(m_min) + 1e-9
        best = jnp.argmax(merits <= m_min + tol)
        merit_new = merits[best]
        improved = merit_new < merit_prev - 1e-12

        # carry the accepted candidate's (r, g) so the final cost/viol
        # need no extra evaluation after the loop
        r_new = jnp.where(improved, r_c[best], r_cur)
        g_new = jnp.where(improved, g_c[best], g_cur)
        x_new = jnp.where(improved, cand[best], x)
        lam_new = jnp.where(improved, jnp.maximum(lam * 0.5, 1e-8), lam * 10.0)
        merit_next = jnp.where(improved, merit_new, merit_prev)

        step_norm = jnp.linalg.norm(alphas[best] * d)
        conv = improved & (step_norm < 1e-7)

        x = jnp.where(done, x, x_new)
        lam = jnp.where(done, lam, lam_new)
        merit_prev = jnp.where(done, merit_prev, merit_next)
        r_cur = jnp.where(done, r_cur, r_new)
        g_cur = jnp.where(done, g_cur, g_new)
        used = used + jnp.where(done, 0, 1)
        done = done | conv | (lam > 1e8)
        if qp_warm_dual:
            return x, lam, merit_prev, done, used, r_cur, g_cur, qp.z
        return x, lam, merit_prev, done, used, r_cur, g_cur

    r0, g0 = eval_fn(x0)
    m0 = merit_of(r0, g0)
    m0 = jnp.where(jnp.isfinite(m0), m0, jnp.inf)
    carry = (
        x0,
        jnp.asarray(1e-4, x0.dtype),
        m0,
        jnp.asarray(False),
        jnp.asarray(0, jnp.int32),
        r0,
        g0,
    )
    if qp_warm_dual:
        carry = carry + (jnp.ones(g0.shape[0], x0.dtype),)
    out = jax.lax.fori_loop(0, iters, body, carry)
    x, lam, m_f, done, used, r, g = out[:7]

    viol = jnp.max(jnp.maximum(g, 0.0))
    return SQPResult(
        x=x,
        cost=jnp.sum(r * r),
        viol=viol,
        iters=used,
        success=viol < viol_tol,
    )
