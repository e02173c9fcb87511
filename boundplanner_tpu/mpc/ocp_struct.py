"""Block-banded structure of the condensed OCP, exploited for the QP.

The reference NLP (`bound_planner/BoundMPC/casadi_ocp_formulation.py:106-380`)
is block-banded by horizon step; after condensing onto the jerk sequence
(`mpc/ocp.py`) that structure survives in two exploitable forms:

1. **Static tail rows.** 850 of the 2439 constraint rows — the variable
   bounds (`BoundMPC.py:544-589` lbx/ubx) and slack nonnegativity — have
   Jacobians that are CONSTANT matrices determined by (N, dt) alone
   (the jerk chain `casadi_ocp_formulation.py:106-120` and trapezoid
   integrations have constant coefficients, identical for every joint and
   every scene). Their contribution to each IPM iteration's normal-equation
   Gram G^T diag(w) G collapses to

   - u-bound rows: a diagonal update (selector rows),
   - q/dq/ddq-bound rows: per-joint 14x14 weighted Grams of the scalar
     impulse-response profile (the rows of one joint touch only that
     joint's jerk columns),
   - slack rows: a 38x38 weighted Gram of a constant (66, 38) matrix,

   i.e. ~0.5 MFLOP instead of 850-row dense Gram work (~32 MFLOP), and
   they drop out of the streamed constraint matrix entirely (35% of the
   dominant HBM stream of the IPM).

2. **Triangular (causal) runtime rows.** Constraint/residual rows of
   horizon step k depend only on u_1..u_k and the slack variables up to
   index k (the jerk chain is causal). Splitting the steps at N/2 and
   gathering each chunk's static column support turns the dense
   (m, 136)^T (m, 136) Gram into one small (~73-column) and one full-width
   product — a further ~1.6x FLOP cut on the remaining Gram work.
   (Adoption note: the chunk split is the FLOP-minimal mode but measured
   ~10% SLOWER end to end — its gathers/scatters are data movement the
   latency-bound tick can't hide; the adopted config runs flat
   (struct_chunked=False). Same for the factored link rows below:
   exact, tested, and off by default on measured wall clock.)

Everything here is scene-independent and built once per (n, dt) in numpy;
the methods are closed over those constants so a scene-``vmap`` broadcasts
them (they are shared weights — real matmuls over the batch).
"""

from __future__ import annotations

import functools

import numpy as np

import jax.numpy as jnp

from ..config import MPC_SET_ROWS, NUM_LINK_SETS
from . import ocp
from .ocp_jac import _static_sensitivities

NJ = ocp.NJ


class OCPStruct:
    """Static structure of the condensed OCP for horizon n, period dt.

    Instances are created via the lru-cached :func:`build` so identity is
    stable — usable as a static jit argument.
    """

    def __init__(self, n: int, dt: float, chunked: bool = True):
        self.n = n
        self.dt = dt
        self.chunked = chunked
        self.nx = ocp.n_vars(n)
        o = NJ * (n - 1)
        self.o = o

        # runtime row layout (must match ocp.evaluate / ocp_jac row order)
        self.per_step_g = MPC_SET_ROWS + 6 + NUM_LINK_SETS * MPC_SET_ROWS + 1
        self.n_term_g = MPC_SET_ROWS + 6
        self.per_step_r = 15 + 3 + 7 + 2 + 9 + 4  # see ocp._step_local
        self.n_term_r = 5 + 6 + 6
        self.m_run = (n - 1) * self.per_step_g + self.n_term_g
        self.m_r = (n - 1) * self.per_step_r + self.n_term_r
        # struct_link row split: dense runtime rows (set/band/phi/term)
        # vs factored link rows (`link_apply` row order)
        self.m_link = (n - 1) * NUM_LINK_SETS * MPC_SET_ROWS
        self.m_dense = self.m_run - self.m_link

        s = _static_sensitivities(n, dt)
        # scalar jerk-chain profiles restricted to free inputs u_1..u_{n-1}
        self.c_q = s["cq"][1:, 1:]      # (n-1, n-1)
        self.c_dq = s["cdq"][1:, 1:]
        self.c_ddq = s["cddq"][1:, 1:]
        # slack-row Jacobian over the 38 slack columns only
        b_slack = np.concatenate(
            [-s["ddsl"], -s["drs_traj"], -s["ddrs"], -s["dps_traj"], -s["ddps"]]
        )[:, o:]
        self.b_slack = b_slack          # (6 + 4n, 38)
        self.m_tail = 8 * NJ * (n - 1) + b_slack.shape[0]
        self.n_slack = self.nx - o

        # chunk A: steps 1..half — static column support
        half = (n - 1) // 2
        self.half = half
        cols = list(range(NJ * half))                      # u_1..u_half
        cols += list(range(o, o + 7))                      # dslacks + rs0
        cols += list(range(o + 7, o + 7 + half + 1))       # drs_0..half
        cols += [o + 7 + n]                                # ps0
        cols += list(range(o + 8 + n, o + 8 + n + half + 1))  # dps_0..half
        self.cols_a = np.asarray(cols, dtype=np.int32)

    # ---- factored link-collision rows -----------------------------------
    #
    # The 6 x 15 link-set rows per step are (NUM_LINK_SETS * MPC_SET_ROWS
    # * (n-1) = 1260 of the 1589 runtime rows — 80%) and factor exactly as
    #
    #   J_link[k, l, r, :] = A[l, r, :] @ acol_u[k, l]  -  e_{dslack_l}
    #
    # with A = a_set_joints (per-scene constant, (6, 15, 3)) and
    # acol_u[k, l] = d(p_col_l(q_k))/du (3, o) — the only x-dependent
    # piece, 3 rows instead of 15. Applying them through this
    # factorization removes 80% of the streamed constraint matrix (the
    # dominant HBM traffic of the IPM) and shrinks their Gram to 3x3
    # inner products sandwiched between acol_u chains.
    # Row order: k-major, then link, then set row (matches
    # `ocp._step_local`'s link block reshaped).

    def link_apply(self, acol_u, a_joints, v):
        """J_link @ v -> (m_link,)."""
        o = self.o
        t = jnp.einsum("klix,x->kli", acol_u, v[:o])
        rows = jnp.einsum("lri,kli->klr", a_joints, t) - v[o : o + 6][None, :, None]
        return rows.reshape(-1)

    def link_apply_t(self, acol_u, a_joints, y):
        """J_link^T @ y -> (nx,)."""
        n, o, nx = self.n, self.o, self.nx
        yk = y.reshape(n - 1, NUM_LINK_SETS, MPC_SET_ROWS)
        t = jnp.einsum("lri,klr->kli", a_joints, yk)
        vu = jnp.einsum("klix,kli->x", acol_u, t)
        vds = -jnp.sum(yk, axis=(0, 2))
        out = jnp.zeros(nx, y.dtype)
        out = out.at[:o].set(vu)
        out = out.at[o : o + 6].set(vds)
        return out

    def link_gram(self, acol_u, a_joints, w):
        """J_link^T diag(w) J_link -> (nx, nx)."""
        n, o, nx = self.n, self.o, self.nx
        wk = w.reshape(n - 1, NUM_LINK_SETS, MPC_SET_ROWS)
        inner = jnp.einsum("lri,klr,lrj->klij", a_joints, wk, a_joints)
        half = jnp.einsum("klij,kljx->klix", inner, acol_u)  # (k,l,3,o)
        uu = jnp.einsum("klix,kliy->xy", acol_u, half)
        # dslack cross terms: rows' -e_{dsl_l} against the u part and
        # against themselves
        cross = -jnp.einsum("lri,klr,klix->lx", a_joints, wk, acol_u)
        w_l = jnp.sum(wk, axis=(0, 2))                       # (6,)
        out = jnp.zeros((nx, nx), w.dtype)
        out = out.at[:o, :o].set(uu)
        out = out.at[o : o + 6, :o].set(cross)
        out = out.at[:o, o : o + 6].set(cross.T)
        out = out.at[o + jnp.arange(6), o + jnp.arange(6)].add(w_l)
        return out

    # ---- static tail: g_tail(x) = [bound rows; slack rows] --------------

    def tail_apply(self, v):
        """G_tail @ v for the 850 static rows (row order of
        `ocp.evaluate`'s g_bounds + g_slack)."""
        n, o = self.n, self.o
        dtype = v.dtype
        vu = v[:o].reshape(n - 1, NJ)
        yq = jnp.asarray(self.c_q, dtype) @ vu
        ydq = jnp.asarray(self.c_dq, dtype) @ vu
        yddq = jnp.asarray(self.c_ddq, dtype) @ vu
        ys = jnp.asarray(self.b_slack, dtype) @ v[o:]
        return jnp.concatenate(
            [
                yq.reshape(-1), -yq.reshape(-1),
                ydq.reshape(-1), -ydq.reshape(-1),
                yddq.reshape(-1), -yddq.reshape(-1),
                vu.reshape(-1), -vu.reshape(-1),
                ys,
            ]
        )

    def tail_apply_t(self, y):
        """G_tail^T @ y."""
        n, o = self.n, self.o
        dtype = y.dtype
        nb = NJ * (n - 1)
        blocks = y[: 8 * nb].reshape(8, n - 1, NJ)
        dq_pm = blocks[0] - blocks[1]
        ddq_pm = blocks[2] - blocks[3]
        dddq_pm = blocks[4] - blocks[5]
        u_pm = blocks[6] - blocks[7]
        vu = (
            jnp.asarray(self.c_q, dtype).T @ dq_pm
            + jnp.asarray(self.c_dq, dtype).T @ ddq_pm
            + jnp.asarray(self.c_ddq, dtype).T @ dddq_pm
            + u_pm
        )
        vs = jnp.asarray(self.b_slack, dtype).T @ y[8 * nb :]
        return jnp.concatenate([vu.reshape(-1), vs])

    def tail_gram(self, w):
        """G_tail^T diag(w) G_tail, assembled structurally: per-joint
        profile Grams + a diagonal (u rows) + the 38x38 slack block."""
        n, o, nx = self.n, self.o, self.nx
        dtype = w.dtype
        nb = NJ * (n - 1)
        wb = w[: 8 * nb].reshape(8, n - 1, NJ)
        w_q = wb[0] + wb[1]
        w_dq = wb[2] + wb[3]
        w_ddq = wb[4] + wb[5]
        w_u = wb[6] + wb[7]

        c_q = jnp.asarray(self.c_q, dtype)
        c_dq = jnp.asarray(self.c_dq, dtype)
        c_ddq = jnp.asarray(self.c_ddq, dtype)
        # per-joint (n-1, n-1) Grams: rows of joint j touch only columns of
        # joint j, so the q/dq/ddq bound families contribute block-diagonal
        # (per-joint) terms over the jerk columns.
        m = (
            jnp.einsum("ka,kj,kb->jab", c_q, w_q, c_q)
            + jnp.einsum("ka,kj,kb->jab", c_dq, w_dq, c_dq)
            + jnp.einsum("ka,kj,kb->jab", c_ddq, w_ddq, c_ddq)
        )  # (NJ, n-1, n-1)
        uu = jnp.zeros((n - 1, NJ, n - 1, NJ), dtype)
        j_idx = jnp.arange(NJ)
        uu = uu.at[:, j_idx, :, j_idx].set(m)  # (NJ, n-1, n-1) diagonal-in-j
        uu = uu.reshape(o, o) + jnp.diag(w_u.reshape(-1))

        b_s = jnp.asarray(self.b_slack, dtype)
        ss = b_s.T @ (w[8 * nb :, None] * b_s)

        out = jnp.zeros((nx, nx), dtype)
        out = out.at[:o, :o].set(uu)
        out = out.at[o:, o:].set(ss)
        return out

    def tail_values(self, traj, dtype, robot="iiwa14"):
        """g_tail(x) values from a rollout — identical formulas (and row
        order) to the g_bounds/g_slack blocks of `ocp.evaluate`."""
        from ..robot.model import DDQ_LIM, U_MAX, U_MIN, ocp_limits

        q_ub_np, q_lb_np, dq_lim_np, _ = ocp_limits(robot)
        q_ub = jnp.asarray(q_ub_np, dtype)
        q_lb = jnp.asarray(q_lb_np, dtype)
        dq_lim = jnp.asarray(dq_lim_np, dtype)
        g_bounds = jnp.concatenate(
            [
                (traj["q"][1:] - q_ub).reshape(-1),
                (q_lb - traj["q"][1:]).reshape(-1),
                (traj["dq"][1:] - dq_lim).reshape(-1),
                (-dq_lim - traj["dq"][1:]).reshape(-1),
                (traj["ddq"][1:] - DDQ_LIM).reshape(-1),
                (-DDQ_LIM - traj["ddq"][1:]).reshape(-1),
                (traj["u"][1:] - U_MAX).reshape(-1),
                (U_MIN - traj["u"][1:]).reshape(-1),
            ]
        )
        g_slack = jnp.concatenate(
            [
                -traj["dslacks"],
                -traj["rslacks"],
                -traj["drs"],
                -traj["pslacks"],
                -traj["dps"],
            ]
        )
        return jnp.concatenate([g_bounds, g_slack])

    # ---- chunked triangular Grams over the runtime rows ------------------

    def _chunk_rows(self, per_step: int, n_rows: int):
        return self.half * per_step, n_rows

    def gram_g(self, g_run, w, lowp: bool = False):
        """G_run^T diag(w) G_run with the causal-support chunk split.

        ``lowp`` streams the chunk matrices in bfloat16 with f32
        accumulation (same contract as `ops.qp.solve_qp`'s Gram).

        Invariant: when ``chunked``, ``g_run`` must carry the FULL m_run
        runtime-row layout — the chunk split assumes rows 0..rows_a are
        exactly steps 1..half of that layout.  A shorter matrix (e.g. the
        struct_link dense-row subset, m_dense rows) would be silently
        clipped by ``mat[:rows_a]`` and produce a wrong Gram, so it is
        rejected at trace time."""
        rows_a = self.half * self.per_step_g if self.chunked else 0
        if rows_a and g_run.shape[0] != self.m_run:
            raise ValueError(
                f"gram_g(chunked=True) needs the full m_run={self.m_run} "
                f"row layout, got {g_run.shape[0]} rows; build the "
                "OCPStruct with chunked=False for partial-row matrices"
            )
        return self._gram(g_run, rows_a, w, lowp)

    def gram_r(self, j_res):
        """J_r^T J_r (unweighted, f32) with the same chunk split — the
        Gauss-Newton Hessian's dominant product.

        Same row-layout invariant as :meth:`gram_g` (m_r rows when
        chunked)."""
        rows_a = self.half * self.per_step_r if self.chunked else 0
        if rows_a and j_res.shape[0] != self.m_r:
            raise ValueError(
                f"gram_r(chunked=True) needs the full m_r={self.m_r} "
                f"row layout, got {j_res.shape[0]} rows; build the "
                "OCPStruct with chunked=False for partial-row matrices"
            )
        return self._gram(j_res, rows_a, None, False)

    def _gram(self, mat, rows_a: int, w, lowp: bool):
        nx = self.nx
        if rows_a == 0:
            dtype = mat.dtype
            if lowp:
                m16 = mat.astype(jnp.bfloat16)
                mw = (
                    m16 * w[:, None].astype(jnp.bfloat16)
                    if w is not None else m16
                )
                return jnp.matmul(
                    m16.T, mw, preferred_element_type=jnp.float32
                ).astype(dtype)
            mw = mat * w[:, None] if w is not None else mat
            return mat.T @ mw
        dtype = mat.dtype
        cols_a = jnp.asarray(self.cols_a)
        a = mat[:rows_a][:, self.cols_a]
        b = mat[rows_a:]
        if w is not None:
            wa, wb = w[:rows_a], w[rows_a:]
        if lowp:
            a16 = a.astype(jnp.bfloat16)
            b16 = b.astype(jnp.bfloat16)
            if w is not None:
                aw = a16 * wa[:, None].astype(jnp.bfloat16)
                bw = b16 * wb[:, None].astype(jnp.bfloat16)
            else:
                aw, bw = a16, b16
            gram_a = jnp.matmul(a16.T, aw, preferred_element_type=jnp.float32)
            gram_b = jnp.matmul(b16.T, bw, preferred_element_type=jnp.float32)
        else:
            aw = a * wa[:, None] if w is not None else a
            bw = b * wb[:, None] if w is not None else b
            gram_a = a.T @ aw
            gram_b = b.T @ bw
        out = gram_b
        out = out.at[jnp.ix_(cols_a, cols_a)].add(gram_a.astype(dtype))
        return out


@functools.lru_cache(maxsize=None)
def build(n: int, dt: float, chunked: bool = True) -> OCPStruct:
    return OCPStruct(n, dt, chunked)
