"""Batched dense convex-QP solver (Mehrotra predictor-corrector IPM).

One batched solver covers every convex subproblem of the engine, in
place of the reference's zoo of native solvers:

- point-into-set projection QPs   (qpOASES/OSQP,
  ref `utils/optimization_functions.py:107-137`, `ConvexSetFinder.py:10-49`)
- line-into-set projection QPs    (qpOASES, `ConvexSetFinder.py:52-99`)
- EE-fit feasibility problems     (qpOASES, `optimization_functions.py:140-183`)
- kinked-path via-point QPs       (qpOASES, `optimization_functions.py:186-224`)
- set-intersection LPs            (HiGHS linprog, `BoundPlanner.py:774-787`)
- the SQP subproblem of the BoundMPC optimal control problem
  (the role of Ipopt's inner iterations, `casadi_ocp_formulation.py:418`)

Design: everything is dense, fixed-shape and expressed as matmuls +
Cholesky factorizations. Problems are
batched with ``vmap``; iteration is a fixed-trip-count ``lax.fori_loop``
with masked updates after convergence so a whole batch stays in lockstep.

Problem form::

    minimize    0.5 x^T P x + q^T x
    subject to  G x <= h

(boxes and equalities are encoded as rows of G by callers; padded inactive
rows use h >> 0 and are harmless to the IPM).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from .linalg import kkt_inverse


class QPSolution(NamedTuple):
    x: jax.Array        # primal solution (n,)
    z: jax.Array        # inequality multipliers (m,)
    s: jax.Array        # slacks h - Gx (m,)
    r_p: jax.Array      # final primal residual (scalar, inf-norm)
    r_d: jax.Array      # final dual residual (scalar, inf-norm)
    gap: jax.Array      # final complementarity s.z/m
    success: jax.Array  # bool: residuals below tolerance


def _step_len(v, dv, tau=0.995):
    """Largest alpha in (0, 1] with v + alpha dv >= (1 - tau) v."""
    ratio = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, tau * jnp.min(ratio))


def kkt_matrix(p_mat, g_mat, w, reg, lowp=False, struct=None, link=None):
    """The IPM's reduced KKT matrix ``P + G^T diag(w) G + reg I`` for the
    scaling ``w = z / s`` (m,), in `solve_qp`'s row order and modes:
    ``struct``/``link`` apply the static and link rows structurally (``g_mat``
    then holds the runtime rows only), ``lowp`` forms the dense Gram from
    bfloat16 operands with float32 accumulation (float32 inputs only)."""
    n = p_mat.shape[0]
    m_run = g_mat.shape[0]
    reg_eye = reg * jnp.eye(n, dtype=p_mat.dtype)
    lowp = lowp and p_mat.dtype == jnp.float32
    if struct is not None:
        kkt = p_mat + struct.gram_g(g_mat, w[:m_run], lowp) + reg_eye
        m_link = 0
        if link is not None:
            m_link = struct.m_link
            kkt = kkt + struct.link_gram(link[0], link[1],
                                         w[m_run : m_run + m_link])
        return kkt + struct.tail_gram(w[m_run + m_link :])
    if lowp:
        g_dir = g_mat.astype(jnp.bfloat16)
        gw = g_dir * w[:, None].astype(jnp.bfloat16)
        return p_mat + jnp.matmul(
            g_dir.T, gw, preferred_element_type=jnp.float32
        ) + reg_eye
    return p_mat + (g_mat.T * w) @ g_mat + reg_eye


@functools.partial(
    jax.jit,
    static_argnames=("iters", "lowp", "kkt_every", "struct", "gondzio",
                     "lowp_rd", "warm_sz"),
)
def solve_qp(
    p_mat: jax.Array,
    q_vec: jax.Array,
    g_mat: jax.Array,
    h_vec: jax.Array,
    x0: Optional[jax.Array] = None,
    iters: int = 30,
    tol: float = 1e-9,
    reg: float = 1e-10,
    lowp: bool = False,
    kkt_every: int = 1,
    struct=None,
    h_tail: Optional[jax.Array] = None,
    gondzio: int = 0,
    link=None,
    h_link: Optional[jax.Array] = None,
    z0: Optional[jax.Array] = None,
    lowp_rd: bool = False,
    warm_sz: bool = False,
) -> QPSolution:
    """Solve one dense QP; ``vmap`` over leading axes for batches.

    ``lowp``: stream the constraint matrix in bfloat16 for the
    SEARCH-DIRECTION products (rhs, G dx, Gram assembly) with float32
    accumulation — halves the dominant memory stream and runs the Gram
    product at the bfloat16 matrix rate. Residual recomputation stays float32 exact;
    the iterative-refinement sweep absorbs the direction error (inexact
    Newton). Ignored for float64 inputs.

    ``kkt_every``: refresh the KKT factorization only every k-th IPM
    iteration; in between, the stale factor serves as a preconditioner and
    extra iterative-refinement sweeps against the EXACT current KKT
    operator (applied implicitly: P v + G^T(w (G v)) — no Gram assembly)
    restore direction accuracy. The factorization + Gram are the dominant
    per-iteration work at OCP sizes, so k=2 removes ~half of it; the
    refinement converges as long as the diagonal scaling w = z/s moved
    less than the (regularized) spectrum allows — gated on closed-loop
    quality like every solver knob.

    ``struct``/``h_tail``: block-banded constraint structure
    (`mpc.ocp_struct.OCPStruct`). When given, ``g_mat``/``h_vec`` carry
    only the RUNTIME rows; the static bound/slack rows (with h values
    ``h_tail``) are applied structurally — per-joint profile products
    instead of dense rows — and the runtime Gram uses the causal-support
    chunk split. The tail rows sit at the END of the row order (matching
    `ocp.evaluate`); solutions are identical to the dense path up to
    float reassociation.
    """
    n = q_vec.shape[0]
    m_run = h_vec.shape[0]
    m_link = 0 if link is None else h_link.shape[0]
    dtype = q_vec.dtype
    lowp = lowp and dtype == jnp.float32

    if struct is not None:
        parts = [h_vec] + ([h_link] if link is not None else []) + [h_tail]
        h_vec = jnp.concatenate(parts)
    m = h_vec.shape[0]

    x = jnp.zeros(n, dtype) if x0 is None else x0
    g_dir = g_mat.astype(jnp.bfloat16) if lowp else g_mat

    def _structured_parts(v):
        if link is None:
            return [struct.tail_apply(v)]
        return [struct.link_apply(link[0], link[1], v), struct.tail_apply(v)]

    def _structured_t(y):
        if link is None:
            return struct.tail_apply_t(y[m_run:])
        return struct.link_apply_t(
            link[0], link[1], y[m_run : m_run + m_link]
        ) + struct.tail_apply_t(y[m_run + m_link :])

    def gmv(v):      # G @ v with f32 accumulation
        if lowp:
            run = jnp.matmul(g_dir, v.astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32)
        else:
            run = g_mat @ v
        if struct is None:
            return run
        return jnp.concatenate([run] + _structured_parts(v))

    def gtmv(v):     # G^T @ v with f32 accumulation
        if lowp:
            run = jnp.matmul(g_dir.T, v[:m_run].astype(jnp.bfloat16),
                             preferred_element_type=jnp.float32)
        else:
            run = g_mat.T @ v[:m_run]
        if struct is None:
            return run
        return run + _structured_t(v)

    def gmv_exact(v):
        run = g_mat @ v
        if struct is None:
            return run
        return jnp.concatenate([run] + _structured_parts(v))

    def gtmv_exact(v):
        run = g_mat.T @ v[:m_run]
        if struct is None:
            return run
        return run + _structured_t(v)

    if warm_sz and z0 is not None:
        # Paired Mehrotra warm start: the
        # round-2 z-only warm start was a measured negative BECAUSE the
        # warm duals were paired with the cold slack floor s = max(., 1),
        # which puts the iterate far off the central path (s_i z_i spread
        # over orders of magnitude). Initialize BOTH from the warm-start
        # point instead — s from the ACTUAL slack h - G x0, z from the
        # inherited duals — then apply Mehrotra's initial-point shifts
        # (the standard least-squares-init centering: push both into the
        # cone, then equalize the complementarity scale s^T z).
        s_hat = h_vec - gmv_exact(x)
        z_hat = jnp.clip(z0, 0.0, 1e6)
        d_s = jnp.maximum(-1.5 * jnp.min(s_hat), 0.0)
        d_z = jnp.maximum(-1.5 * jnp.min(z_hat), 0.0)
        s1 = s_hat + d_s
        z1 = z_hat + d_z
        mu0 = jnp.dot(s1, z1)
        s = s1 + 0.5 * mu0 / jnp.maximum(jnp.sum(z1), 1e-12)
        z = z1 + 0.5 * mu0 / jnp.maximum(jnp.sum(s1), 1e-12)
        s = jnp.maximum(s, 1e-8)
        z = jnp.maximum(z, 1e-8)
    else:
        s = jnp.maximum(h_vec - gmv_exact(x), 1.0)
        # dual warm start (e.g. from the previous SQP iteration's QP): clip
        # into a safe cone so w = z/s starts near the inherited active set
        z = jnp.ones(m, dtype) if z0 is None else jnp.clip(z0, 1e-6, 1e6)

    def assemble_kkt(w):
        return kkt_matrix(p_mat, g_mat, w, reg, lowp, struct, link)

    def body(it, carry):
        # r_p rides along recursively: the Newton row G dx + ds = -r_p
        # holds EXACTLY as ds is constructed (-r_p - G dx), so a combined
        # step of length alpha gives r_p_new = (1 - alpha) r_p up to the
        # slack floor — one full pass over G saved per iteration (G is the
        # dominant HBM stream of the IPM at OCP sizes: (2439, 136) x
        # batch). The DUAL residual is recomputed exactly: its recursion
        # would inherit the KKT solve error, which measurably degrades
        # closed-loop quality in f32 (fleet success 1.00 -> 0.80/0.90 even
        # with iterative refinement).
        if kkt_every == 1:
            x, s, z, r_p, done = carry
        else:
            x, s, z, r_p, done, l_inv = carry
        # the dual residual is recomputed (never carried recursively —
        # that inherits KKT solve error and accumulates, round-1 negative).
        # lowp_rd computes the G^T z stream in bf16: a BOUNDED per-
        # iteration rounding of the Newton rhs (absorbed by the line
        # search), saving the last remaining f32 full-G passes.
        r_d = p_mat @ x + q_vec + (gtmv(z) if lowp_rd else gtmv_exact(z))
        mu = jnp.dot(s, z) / m

        w = z / s                                        # (m,)
        # the factor is inverted explicitly so the solves of each
        # iteration (predictor, corrector, Gondzio, refinement) are
        # matvecs instead of sequential substitutions
        if kkt_every == 1:
            kkt = assemble_kkt(w)
            l_inv = kkt_inverse(kkt)

            def kkt_mv(v):
                return kkt @ v

            n_refine = 1
        else:
            # frozen-factor mode: the factorization (and the Gram behind
            # it) refreshes only on it % kkt_every == 0; refinement runs
            # against the exact CURRENT KKT applied implicitly (two G
            # passes per sweep — no Gram assembly on frozen iterations).
            l_inv = jax.lax.cond(
                it % kkt_every == 0,
                lambda: kkt_inverse(assemble_kkt(w)),
                lambda: l_inv,
            )

            def kkt_mv(v):
                return p_mat @ v + gtmv(w * gmv(v)) + reg * v

            n_refine = 2

        def solve_dx(r_c):
            rhs = -r_d + gtmv((r_c - z * r_p) / s)
            dx = l_inv.T @ (l_inv @ rhs)
            # iterative-refinement sweeps against the exact KKT operator:
            # the recursive r_d update below relies on P dx + G^T dz = -r_d,
            # which holds only as accurately as this solve (f32 explicit
            # inverses leave ~1e-6 relative error — enough to corrupt the
            # carried dual residual and the subsequent search directions;
            # a stale factor leaves far more, hence the extra sweep).
            for _ in range(n_refine):
                resid = rhs - kkt_mv(dx)
                dx = dx + l_inv.T @ (l_inv @ resid)
            ds = -r_p - gmv(dx)
            dz = -(r_c + z * ds) / s
            return dx, ds, dz

        # predictor (affine)
        r_c_aff = s * z
        dx_a, ds_a, dz_a = solve_dx(r_c_aff)
        alpha_p = _step_len(s, ds_a)
        alpha_d = _step_len(z, dz_a)
        mu_aff = jnp.dot(s + alpha_p * ds_a, z + alpha_d * dz_a) / m
        # dtype-aware floor: a 1e-300 literal underflows to 0.0 in f32 (the
        # production dtype) and would guard nothing when mu == 0
        tiny = jnp.finfo(dtype).tiny
        sigma = jnp.clip((mu_aff / jnp.maximum(mu, tiny)) ** 3, 0.0, 1.0)

        # corrector
        r_c = s * z - sigma * mu + ds_a * dz_a
        dx, ds, dz = solve_dx(r_c)
        alpha_p = _step_len(s, ds)
        alpha_d = _step_len(z, dz)

        # Gondzio multiple-centrality correctors: re-use the factorization
        # (solves are matvecs against the explicit inverse) to push the
        # trial complementarity products of an extended step back into a
        # neighborhood of the central path — buys larger steps per
        # factorization, i.e. fewer IPM iterations for the same accuracy.
        # same dtype-aware floor: with an underflowed literal the Gondzio
        # clip band would collapse to [0, 0] whenever sigma*mu == 0 and
        # t_corr would target exact-zero complementarity
        mu_t = jnp.maximum(sigma * mu, tiny)
        for _ in range(gondzio):
            a_try_p = jnp.minimum(alpha_p + 0.08, 1.0)
            a_try_d = jnp.minimum(alpha_d + 0.08, 1.0)
            v_try = (s + a_try_p * ds) * (z + a_try_d * dz)
            t_corr = jnp.clip(v_try, 0.1 * mu_t, 10.0 * mu_t) - v_try
            dx2, ds2, dz2 = solve_dx(r_c - t_corr)
            a2_p = _step_len(s, ds2)
            a2_d = _step_len(z, dz2)
            better = jnp.minimum(a2_p, a2_d) >= jnp.minimum(alpha_p, alpha_d)
            dx = jnp.where(better, dx2, dx)
            ds = jnp.where(better, ds2, ds)
            dz = jnp.where(better, dz2, dz)
            alpha_p = jnp.where(better, a2_p, alpha_p)
            alpha_d = jnp.where(better, a2_d, alpha_d)
        alpha = jnp.minimum(alpha_p, alpha_d)

        x_new = x + alpha * dx
        s_new = jnp.maximum(s + alpha * ds, 1e-14)
        z_new = jnp.maximum(z + alpha * dz, 1e-14)
        r_p_new = (1.0 - alpha) * r_p + (s_new - (s + alpha * ds))

        finite = (
            jnp.all(jnp.isfinite(x_new))
            & jnp.all(jnp.isfinite(s_new))
            & jnp.all(jnp.isfinite(z_new))
            & jnp.isfinite(alpha)
        )
        keep = done | ~finite
        x = jnp.where(keep, x, x_new)
        s = jnp.where(keep, s, s_new)
        z = jnp.where(keep, z, z_new)
        r_p = jnp.where(keep, r_p, r_p_new)
        done = done | ~finite

        conv = (
            (jnp.max(jnp.abs(r_p)) < tol)
            & (jnp.max(jnp.abs(r_d)) < tol)
            & (mu < tol)
        )
        if kkt_every == 1:
            return x, s, z, r_p, done | conv
        return x, s, z, r_p, done | conv, l_inv

    r_p0 = gmv_exact(x) + s - h_vec
    carry0 = (x, s, z, r_p0, jnp.asarray(False))
    if kkt_every > 1:
        carry0 = carry0 + (jnp.zeros((n, n), dtype),)
    out = jax.lax.fori_loop(0, iters, body, carry0)
    x, s, z = out[0], out[1], out[2]

    r_d = jnp.max(jnp.abs(p_mat @ x + q_vec + gtmv_exact(z)))
    r_p = jnp.max(jnp.maximum(gmv_exact(x) - h_vec, 0.0))
    gap = jnp.dot(s, z) / m
    success = (r_p < 1e-6) & (r_d < 1e-4)
    return QPSolution(x=x, z=z, s=s, r_p=r_p, r_d=r_d, gap=gap, success=success)


def solve_projection(g_mat, h_vec, target, iters: int = 30):
    """min |x - target|^2  s.t. G x <= h  — the projection QP of
    `optimization_functions.py:107-137` / `ConvexSetFinder.py:10-49`."""
    n = target.shape[0]
    p_mat = 2.0 * jnp.eye(n, dtype=target.dtype)
    q_vec = -2.0 * target
    return solve_qp(p_mat, q_vec, g_mat, h_vec, x0=None, iters=iters)


def solve_line_projection(g_mat, h_vec, p0, p1, iters: int = 30):
    """min |p0 + phi (p1-p0) - x|^2  s.t. G x <= h, 0 <= phi <= 1 —
    the line projection QP of `ConvexSetFinder.py:52-99`.

    Decision vector y = (x, phi) in R^4. Returns (x, phi, sol).
    """
    dtype = p0.dtype
    d = p1 - p0
    # cost: |x - phi d - p0|^2
    p_mat = jnp.zeros((4, 4), dtype)
    p_mat = p_mat.at[:3, :3].set(2.0 * jnp.eye(3, dtype=dtype))
    p_mat = p_mat.at[:3, 3].set(-2.0 * d)
    p_mat = p_mat.at[3, :3].set(-2.0 * d)
    p_mat = p_mat.at[3, 3].set(2.0 * jnp.dot(d, d) + 1e-9)
    q_vec = jnp.concatenate([-2.0 * p0, jnp.array([2.0 * jnp.dot(p0, d)], dtype)])
    m = h_vec.shape[0]
    g_full = jnp.zeros((m + 2, 4), dtype)
    g_full = g_full.at[:m, :3].set(g_mat)
    g_full = g_full.at[m, 3].set(1.0)
    g_full = g_full.at[m + 1, 3].set(-1.0)
    h_full = jnp.concatenate([h_vec, jnp.array([1.0, 0.0], dtype)])
    sol = solve_qp(p_mat, q_vec, g_full, h_full, iters=iters)
    return sol.x[:3], sol.x[3], sol


def solve_feasibility(g_mat, h_vec, x0=None, iters: int = 30, eps: float = 1e-6):
    """Phase-1: minimize the worst violation t of G x <= h + t.

    Replaces the qpOASES "fit" feasibility probes
    (`optimization_functions.py:140-183`) and the HiGHS intersection LP
    (`BoundPlanner.py:774-787`). Returns (x, t, sol): feasible iff t <~ 0.

    Boundedness invariant (audited round 3): the eps-regularization makes
    the QP strongly convex, so it never diverges — but on a ROW SET whose
    phase-1 variable t is unbounded below (no row clamps it), t slides to
    -1/(2 eps) (~-5e5) with |x| of matching magnitude: finite yet useless,
    and in f32 rounding-dominated. Every in-repo caller is safe, for one
    of two reasons:

    - planner intersection / EE-fit probes (`planner/planner.py`,
      `planner/via_opt.py`): (a) every set from `planner.set_finder`
      starts with the 6 workspace box rows
      (`set_finder._init_rows_workspace`, ref `ConvexSetFinder.py:377-398`),
      so x itself is bounded; and (b) independently, the `_pad` inactive
      rows (zero normal, b=10) read 0.x <= 10 + t, i.e. they clamp
      t >= -10, so even a degenerate padded problem stays at O(10) scale.
    - `ops.mvie._chebyshev_center` concatenates its own radius-10 box.

    A caller passing UNPADDED rows that bound neither x nor t gets the
    -1/(2 eps) drift. Both regimes are pinned by
    `tests/test_qp.py::test_feasibility_unbounded_polytope`.
    """
    n = g_mat.shape[1]
    m = h_vec.shape[0]
    dtype = h_vec.dtype
    p_mat = jnp.eye(n + 1, dtype=dtype) * eps
    q_vec = jnp.zeros(n + 1, dtype).at[n].set(1.0)
    g_full = jnp.concatenate([g_mat, -jnp.ones((m, 1), dtype)], axis=1)
    x0_full = None if x0 is None else jnp.concatenate(
        [x0, jnp.array([jnp.max(g_mat @ x0 - h_vec) + 1.0], dtype)]
    )
    sol = solve_qp(p_mat, q_vec, g_full, h_vec, x0=x0_full, iters=iters)
    return sol.x[:n], sol.x[n], sol


@functools.partial(jax.jit, static_argnames=("iters",))
def solve_qp_admm(
    p_mat: jax.Array,
    q_vec: jax.Array,
    g_mat: jax.Array,
    h_vec: jax.Array,
    x0: Optional[jax.Array] = None,
    iters: int = 60,
    rho: float = 1.0,
    sigma: float = 1e-6,
    alpha: float = 1.6,
) -> QPSolution:
    """OSQP-style ADMM for  min 0.5 x'Px + q'x  s.t.  Gx <= h.

    One factorization of K = P + sigma I + rho G'G per call (vs one per
    iteration for the IPM) and ~``iters`` cheap matvec iterations — the
    factor-once pattern of OSQP/ReLU-QP (see PAPERS.md). Inside an SQP the
    looser per-subproblem accuracy is absorbed by the merit line search.

    Returns the same QPSolution interface as ``solve_qp`` (s = h - Gx,
    z = ADMM dual y clipped to >= 0).
    """
    n = q_vec.shape[0]
    m = h_vec.shape[0]
    dtype = q_vec.dtype

    # scale rows to unit norm for a better-conditioned fixed rho
    row_norm = jnp.sqrt(jnp.sum(g_mat * g_mat, axis=1))
    scale = 1.0 / jnp.maximum(row_norm, 1e-6)
    g_s = g_mat * scale[:, None]
    h_s = h_vec * scale

    kkt = p_mat + sigma * jnp.eye(n, dtype=dtype) + rho * (g_s.T @ g_s)
    l_inv = kkt_inverse(kkt)

    def solve(rhs):
        return l_inv.T @ (l_inv @ rhs)

    x = jnp.zeros(n, dtype) if x0 is None else x0
    z = jnp.minimum(g_s @ x, h_s)
    y = jnp.zeros(m, dtype)

    def body(_, carry):
        x, z, y = carry
        rhs = sigma * x - q_vec + g_s.T @ (rho * z - y)
        x_t = solve(rhs)
        x_new = alpha * x_t + (1.0 - alpha) * x
        gx = g_s @ x_new
        z_new = jnp.minimum(gx + y / rho, h_s)
        y_new = y + rho * (gx - z_new)
        y_new = jnp.maximum(y_new, 0.0)  # inequality dual cone
        return x_new, z_new, y_new

    x, z, y = jax.lax.fori_loop(0, iters, body, (x, z, y))

    s = h_vec - g_mat @ x
    r_p = jnp.max(jnp.maximum(g_mat @ x - h_vec, 0.0))
    r_d = jnp.max(jnp.abs(p_mat @ x + q_vec + g_s.T @ y))
    gap = jnp.dot(jnp.maximum(s, 0.0), y * scale) / m
    success = r_p < 1e-4
    return QPSolution(x=x, z=y * scale, s=s, r_p=r_p, r_d=r_d, gap=gap,
                      success=success)
