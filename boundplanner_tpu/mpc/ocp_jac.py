"""Manual chain-rule Jacobians for the condensed OCP.

``jacfwd(evaluate)`` pushes n_vars (136) tangents through the ENTIRE
evaluation — rollout scan, FK, reference/error math, and the (affine!)
bound rows. This module exploits the problem structure instead:

- q/dq/ddq/u and the slack trajectories are AFFINE in x with STATIC
  sensitivity matrices (the jerk chain `casadi_ocp_formulation.py:106-120`
  and trapezoid integrations `:121-141` have constant coefficients) —
  computed once in numpy at trace time, contributing zero runtime AD.
- the FK quantities (p_pos, v = J dq, collision-frame positions) are
  differentiated per step w.r.t. q_k only: 7 tangents instead of 136.
- the reference/error math (`ocp._step_local`) is differentiated w.r.t.
  its 61 packed local inputs per step, vmapped over the horizon.
- variable-bound and slack-nonnegativity rows get their exact static
  Jacobians directly — no AD at all.

The pieces compose into the full (residual, constraint) Jacobians with a
few batched einsums. Row order matches `ocp.evaluate` exactly;
`tests/test_ocp_jac.py` verifies both values and Jacobians against
``jacfwd(evaluate)`` in float64.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..config import MPCParams, MPC_SET_ROWS, NUM_LINK_SETS
from ..robot import kinematics as kin
from . import ocp

NJ = ocp.NJ


@functools.lru_cache(maxsize=None)
def _static_sensitivities(n: int, dt: float):
    """All constant sensitivity matrices for horizon length n.

    Returns a dict of numpy arrays:
      dq, ddq, dddq: (n, NJ, nx) — state sensitivities w.r.t. x
      du:            (n, NJ, nx) — jerk rows (selectors; row 0 is zero)
      cq, cdq, cddq: (n, n)      — scalar impulse responses of the jerk
                                   chain (per-joint identical profiles);
                                   dq[k, j, 7(m-1)+j] == cq[k, m] etc.
      w_trap:        (n, n-1)    — trapezoid weights over runtime rows
                                   j=1..n-1 (column j-1) for iw integration
      drs_traj, dps_traj: (n, nx) — integrated slack trajectories
      ddrs, ddps:    (n, nx)     — slack-rate selectors
      ddsl:          (6, nx)     — dslack selector
    """
    nx = ocp.n_vars(n)
    o = NJ * (n - 1)

    # scalar impulse responses of the jerk chain (per-joint identical;
    # shared with the closed-form rollout)
    cq, cdq, cddq = ocp.jerk_chain_profiles(n, float(dt))

    dq_s = np.zeros((n, NJ, nx))
    ddq_s = np.zeros((n, NJ, nx))
    dddq_s = np.zeros((n, NJ, nx))
    du_s = np.zeros((n, NJ, nx))
    for k in range(n):
        for m in range(1, n):  # m = 0 is the measured jerk (parameter)
            cols = NJ * (m - 1) + np.arange(NJ)
            dq_s[k, np.arange(NJ), cols] = cq[k, m]
            ddq_s[k, np.arange(NJ), cols] = cdq[k, m]
            dddq_s[k, np.arange(NJ), cols] = cddq[k, m]
        if k >= 1:
            du_s[k, np.arange(NJ), NJ * (k - 1) + np.arange(NJ)] = 1.0

    # trapezoid weights: f[k] = f0 + 0.5*dt*(g[0] + 2 g[1..k-1] + g[k])
    w_full = np.zeros((n, n))
    for k in range(1, n):
        w_full[k, 0] = 0.5 * dt
        w_full[k, k] = 0.5 * dt
        w_full[k, 1:k] = dt
    w_trap = w_full[:, 1:]  # runtime rows j = 1..n-1

    drs_traj = np.zeros((n, nx))
    dps_traj = np.zeros((n, nx))
    ddrs = np.zeros((n, nx))
    ddps = np.zeros((n, nx))
    drs_traj[:, o + 6] = 1.0
    dps_traj[:, o + 7 + n] = 1.0
    for k in range(n):
        drs_traj[k, o + 7 : o + 7 + n] = w_full[k]
        dps_traj[k, o + 8 + n : o + 8 + 2 * n] = w_full[k]
        ddrs[k, o + 7 + k] = 1.0
        ddps[k, o + 8 + n + k] = 1.0
    ddsl = np.zeros((6, nx))
    ddsl[np.arange(6), o + np.arange(6)] = 1.0

    return {
        "dq": dq_s,
        "ddq": ddq_s,
        "dddq": dddq_s,
        "du": du_s,
        "cq": cq,
        "cdq": cdq,
        "cddq": cddq,
        "w_trap": w_trap,
        "drs_traj": drs_traj,
        "dps_traj": dps_traj,
        "ddrs": ddrs,
        "ddps": ddps,
        "ddsl": ddsl,
    }


@functools.lru_cache(maxsize=None)
def _static_bound_rows(n: int, dt: float):
    """Exact Jacobian of the variable-bound + slack rows of
    `ocp.evaluate` (all affine in x): (n_rows, nx) numpy constant."""
    s = _static_sensitivities(n, dt)
    flat = lambda a: a.reshape(-1, a.shape[-1])
    jq = flat(s["dq"][1:])
    jdq = flat(s["ddq"][1:])
    jddq = flat(s["dddq"][1:])
    ju = flat(s["du"][1:])
    g_bounds = np.concatenate([jq, -jq, jdq, -jdq, jddq, -jddq, ju, -ju])
    g_slack = np.concatenate(
        [-s["ddsl"], -s["drs_traj"], -s["ddrs"], -s["dps_traj"], -s["ddps"]]
    )
    return np.concatenate([g_bounds, g_slack])


def _fk_bundle(q, dq, chain=None):
    """Per-step FK quantities whose q-derivatives the chain rule needs."""
    return (
        kin.fk_pos(q, chain),
        kin.jacobian_fk(q, chain) @ dq,
        kin.fk_pos_col_all(q, chain)[:NUM_LINK_SETS],
    )


def evaluate_with_jac(x, params, cfg: MPCParams):
    """(residuals, constraints, J_residuals, J_constraints) with the same
    values and row order as `ocp.evaluate` + its ``jacfwd``."""
    n = cfg.n
    nx = ocp.n_vars(n)
    dtype = x.dtype
    w = params["weights"]
    s = _static_sensitivities(n, cfg.dt)

    chain = kin.chain_by_name(cfg.robot)
    traj = ocp.rollout(x, params, cfg)
    zs = ocp.local_inputs(traj, n, chain)
    ks = jnp.arange(1, n)

    # ---- values + per-step local Jacobians (61 tangents, vmapped) ----
    r_steps, g_steps = jax.vmap(
        lambda k, z: ocp._step_local(k, z, params, cfg)
    )(ks, zs)
    jr_z, jg_z = jax.vmap(
        lambda k, z: jax.jacfwd(lambda zz: ocp._step_local(k, zz, params, cfg))(z)
    )(ks, zs)

    # ---- runtime FK derivative bundles (7 tangents, vmapped) ----
    ap, hv, acol = jax.vmap(
        jax.jacfwd(lambda q, dq: _fk_bundle(q, dq, chain), argnums=0)
    )(
        traj["q"][1:], traj["dq"][1:]
    )  # (n-1, 3, 7), (n-1, 6, 7), (n-1, 6, 3, 7)
    jacs = jax.vmap(lambda qq: kin.jacobian_fk(qq, chain))(traj["q"][1:])  # (n-1, 6, 7)

    dq_r = jnp.asarray(s["dq"][1:], dtype)       # (n-1, 7, nx)
    ddq_r = jnp.asarray(s["ddq"][1:], dtype)
    du_r = jnp.asarray(s["du"][1:], dtype)

    dv = jnp.einsum("kij,kjx->kix", hv, dq_r) + jnp.einsum(
        "kij,kjx->kix", jacs, ddq_r
    )  # (n-1, 6, nx)
    w_trap = jnp.asarray(s["w_trap"][1:], dtype)  # (n-1, n-1)
    diw = jnp.einsum("kj,jax->kax", w_trap, dv[:, 3:, :])  # (n-1, 3, nx)
    dp = jnp.concatenate([jnp.einsum("kij,kjx->kix", ap, dq_r), diw], axis=1)
    dpcol = jnp.einsum("klij,kjx->klix", acol, dq_r).reshape(n - 1, 18, nx)

    ddsl = jnp.asarray(s["ddsl"], dtype)
    one = lambda a: jnp.asarray(a, dtype)[1:, None, :]  # (n-1, 1, nx)
    dz = jnp.concatenate(
        [
            dq_r,
            ddq_r,
            du_r,
            dp,
            dv,
            one(s["drs_traj"]),
            one(s["ddrs"]),
            one(s["dps_traj"]),
            one(s["ddps"]),
            jnp.broadcast_to(ddsl, (n - 1, 6, nx)),
            dpcol,
        ],
        axis=1,
    )  # (n-1, N_Z, nx)

    jr_steps = jnp.einsum("krz,kzx->krx", jr_z, dz).reshape(-1, nx)
    jg_steps = jnp.einsum("krz,kzx->krx", jg_z, dz).reshape(-1, nx)

    # ---- terminal rows ----
    g_term = ocp._terminal_local(zs[-1], params, cfg)
    jg_term = jax.jacfwd(lambda zz: ocp._terminal_local(zz, params, cfg))(zs[-1])
    jg_term = jg_term @ dz[-1]

    # ---- terminal residuals (affine + v[N-1]) ----
    slacks = params["slacks0"] + traj["dslacks"]
    r_term = jnp.concatenate(
        [
            jnp.sqrt(w[8]) * slacks[jnp.array([0, 1, 2, 3, 5])],
            jnp.sqrt(w[10]) * traj["dslacks"],
            jnp.sqrt(jnp.asarray(100.0, dtype)) * traj["v"][n - 1],
        ]
    )
    jr_term = jnp.concatenate(
        [
            jnp.sqrt(w[8]) * ddsl[jnp.array([0, 1, 2, 3, 5])],
            jnp.sqrt(w[10]) * ddsl,
            jnp.sqrt(jnp.asarray(100.0, dtype)) * dv[-1],
        ]
    )

    # ---- affine bound/slack rows (values from evaluate's formulas) ----
    from ..robot.model import DDQ_LIM, U_MAX, U_MIN, ocp_limits

    q_ub_np, q_lb_np, dq_lim_np, _ = ocp_limits(cfg.robot)
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
    jg_static = jnp.asarray(_static_bound_rows(n, cfg.dt), dtype)

    residuals = jnp.concatenate([r_steps.reshape(-1), r_term])
    constraints = jnp.concatenate([g_steps.reshape(-1), g_term, g_bounds, g_slack])
    j_res = jnp.concatenate([jr_steps, jr_term])
    j_con = jnp.concatenate([jg_steps, jg_term, jg_static])
    return residuals, constraints, j_res, j_con


# --------------------------------------------------------------------------
# Structured (block-banded) evaluation.
#
# `evaluate_with_jac` still differentiates `_step_local` w.r.t. all 61
# packed local inputs. But the reference/error math
# (`bound_mpc_functions.py:85-390`) depends on the decision vector ONLY
# through the pose p and twist v (12 numbers per step); every other row is
# affine in z with static (or per-scene-constant) coefficients:
#   - dq/u residual rows: sqrt(w)-scaled static selectors,
#   - slack residual rows and the slack addends of the set/band rows:
#     static trapezoid/selector matrices,
#   - link-collision rows: linear in p_col with the per-scene a_set_joints.
# So the per-step AD sweep shrinks from 61 to 12 tangents and the chain
# einsum from (rows,61)x(61,nx) to (rows,12)x(12,nx) — ~5x less AD work
# and the bound/slack rows leave the returned Jacobian entirely (the QP
# consumes them as the structured static tail, `mpc/ocp_struct.py`).
# --------------------------------------------------------------------------

# The (p, v)-nonlinear rows inside a step's residual block are rows
# 0-25 — one contiguous block in exactly `_step_nl`'s order — followed by
# the 14 x-affine rows (dq 3, u 7, rs/drs/ps/dps 4); the jr_steps
# concatenation in `evaluate_with_jac_structured` and the 21/111-row
# runtime-constraint split in `ocp_struct` encode exactly this layout.
# Any change to `_step_local`'s row order must update both.


def _step_nl(k, p, v, params, cfg: MPCParams):
    """The (p, v)-dependent parts of `_step_local`'s rows, with the
    slack/linear addends omitted (they are x-affine with static
    coefficients). Row values still match `_step_local` exactly once the
    addends are re-applied — same expression order, so bit-identical."""
    n, nr_segs = cfg.n, cfg.nr_segs
    w = params["weights"]
    zd = {"p": p, "v": v}
    ref, err = ocp._ref_err_of_z(k, zd, params, n, nr_segs)

    phi, dphi = ref["phi"], ref["dphi"]
    sigm = 1.0 / (1.0 + jnp.exp(-60.0 * (phi - (params["phi_max"] - 0.05))))
    v_orth = v - dphi * ref["dp_d"]
    one_norm = ocp.ref_fns.approx_one_norm(params["x_phi_d"][0] - phi)
    r_nl = jnp.concatenate(
        [
            sigm * err["e_r"],
            sigm * err["e_p"],
            jnp.sqrt(w[1]) * err["e_r_par"],
            jnp.sqrt(w[2]) * v_orth[:3],
            jnp.sqrt(w[3]) * v_orth[3:],
            jnp.sqrt(w[5]) * (params["x_phi_d"][1] - dphi)[None],
            jnp.sqrt(w[4] * jnp.maximum(one_norm, 0.0) + 1e-14)[None],
            jnp.sqrt(w[0]) * err["e_p"],
            jnp.sqrt(w[1] / 50.0) * err["e_r_orth1"],
            jnp.sqrt(w[1] / 50.0) * err["e_r_orth2"],
        ]
    )

    proj1 = jnp.dot(ref["br1_current"], err["e_r_orth1"])
    proj_par = jnp.dot(ref["dp_normed_d"], err["e_r_par"])
    proj2 = jnp.dot(ref["br2_current"], err["e_r_orth2"])
    projs = jnp.stack([proj1, proj_par, proj2])
    g_nl = jnp.concatenate(
        [
            ref["a_current"] @ p[:3] - ref["b_current"],
            projs - ref["r_bound_upper"],
            ref["r_bound_lower"] - projs,
            (ref["phi"] - (ref["phi_end_seg"] + 0.005))[None],
        ]
    )
    return r_nl, g_nl


def evaluate_with_jac_structured(x, params, cfg: MPCParams):
    """(r, g_full, J_r, J_g_runtime): values identical to `ocp.evaluate`,
    Jacobians for the RUNTIME rows only (step + terminal; the first
    `OCPStruct.m_run` constraint rows). The 850 static bound/slack rows'
    Jacobians are implicit — `mpc/ocp_struct.py` applies them
    structurally inside the QP."""
    from . import ocp_struct

    n = cfg.n
    nx = ocp.n_vars(n)
    dtype = x.dtype
    w = params["weights"]
    s = _static_sensitivities(n, cfg.dt)
    st = ocp_struct.build(n, cfg.dt)

    chain = kin.chain_by_name(cfg.robot)
    traj = ocp.rollout(x, params, cfg)
    zs = ocp.local_inputs(traj, n, chain)
    ks = jnp.arange(1, n)

    # ---- values: the same vmapped `_step_local` as `evaluate` ----
    r_steps, g_steps = jax.vmap(
        lambda k, z: ocp._step_local(k, z, params, cfg)
    )(ks, zs)

    # ---- nonlinear-core Jacobians: 12 (p, v) tangents per step ----
    jr_pv, jg_pv = jax.vmap(
        lambda k, p, v: jax.jacfwd(
            lambda pv: _step_nl(k, pv[:6], pv[6:], params, cfg)
        )(jnp.concatenate([p, v]))
    )(ks, traj["p"][1:], traj["v"][1:])  # (n-1, 26, 12), (n-1, 22, 12)

    # ---- runtime FK derivative bundles (7 tangents, vmapped) ----
    ap, hv, acol = jax.vmap(
        jax.jacfwd(lambda q, dq: _fk_bundle(q, dq, chain), argnums=0)
    )(
        traj["q"][1:], traj["dq"][1:]
    )  # (n-1, 3, 7), (n-1, 6, 7), (n-1, 6, 3, 7)
    jacs = jax.vmap(lambda qq: kin.jacobian_fk(qq, chain))(traj["q"][1:])  # (n-1, 6, 7)

    dq_r = jnp.asarray(s["dq"][1:], dtype)       # (n-1, 7, nx)
    ddq_r = jnp.asarray(s["ddq"][1:], dtype)
    du_r = jnp.asarray(s["du"][1:], dtype)

    dv = jnp.einsum("kij,kjx->kix", hv, dq_r) + jnp.einsum(
        "kij,kjx->kix", jacs, ddq_r
    )  # (n-1, 6, nx)
    w_trap = jnp.asarray(s["w_trap"][1:], dtype)  # (n-1, n-1)
    diw = jnp.einsum("kj,jax->kax", w_trap, dv[:, 3:, :])  # (n-1, 3, nx)
    dp = jnp.concatenate([jnp.einsum("kij,kjx->kix", ap, dq_r), diw], axis=1)
    dpv = jnp.concatenate([dp, dv], axis=1)  # (n-1, 12, nx)

    jr_nl = jnp.einsum("krt,ktx->krx", jr_pv, dpv)  # (n-1, 26, nx)
    jg_nl = jnp.einsum("krt,ktx->krx", jg_pv, dpv)  # (n-1, 22, nx)

    # ---- assemble the step residual Jacobian (affine rows static) ----
    drs_traj = jnp.asarray(s["drs_traj"][1:], dtype)  # (n-1, nx)
    ddrs = jnp.asarray(s["ddrs"][1:], dtype)
    dps_traj = jnp.asarray(s["dps_traj"][1:], dtype)
    ddps = jnp.asarray(s["ddps"][1:], dtype)
    ddsl = jnp.asarray(s["ddsl"], dtype)  # (6, nx)

    # single ordered concatenation (a zeros+scatter assembly materializes
    # the (n-1, 40, nx) buffer once per .at[].set — pure-copy time).
    # `_step_local` keeps the 26 NL rows contiguous, so the NL block
    # splices in whole — two fusable chunks instead of four interleaved
    # slices.
    jr_steps = jnp.concatenate(
        [
            jr_nl,                                  # rows 0-25 (NL)
            jnp.sqrt(w[6]) * ddq_r[:, 2:5, :],      # rows 26-28
            jnp.sqrt(w[7]) * du_r,                  # rows 29-35
            jnp.sqrt(w[9]) * drs_traj[:, None, :],  # row 36
            jnp.sqrt(w[10]) * ddrs[:, None, :],     # row 37
            jnp.sqrt(w[9]) * dps_traj[:, None, :],  # row 38
            jnp.sqrt(w[10]) * ddps[:, None, :],     # row 39
        ],
        axis=1,
    )

    # ---- assemble the step constraint Jacobian ----
    # set rows (15): NL part - pslack trajectory; band rows (6): NL -+ rslack
    jg_set = jg_nl[:, :15, :] - dps_traj[:, None, :]
    jg_band = jg_nl[:, 15:21, :] - drs_traj[:, None, :]
    # link rows (90): linear in p_col through the per-scene set matrices.
    # Contraction order: the TINY dims first (A_l . acol over i, 3 MACs)
    # into ab (n-1, 90, 7), then ONE batched (90, 7) @ (7, nx) matmul emits
    # the link block directly in its final row-major shape, with no
    # (n-1, 6, 3, nx) intermediate and no (6, 15) -> 90 merge copy. Same
    # math, float reassociation only.
    if not cfg.struct_link:
        ab = jnp.einsum(
            "lri,klij->klrj", params["a_set_joints"], acol
        ).reshape(n - 1, NUM_LINK_SETS * MPC_SET_ROWS, NJ)
        ddsl_link = jnp.repeat(
            ddsl[:NUM_LINK_SETS], MPC_SET_ROWS, axis=0
        )  # (90, nx)
        jg_link = jnp.einsum("krj,kjx->krx", ab, dq_r) - ddsl_link[None]
        jg_steps = jnp.concatenate(
            [jg_set, jg_band, jg_link, jg_nl[:, 21:22, :]], axis=1
        )

    # ---- terminal rows (values + 61-tangent local jacfwd, one step) ----
    g_term = ocp._terminal_local(zs[-1], params, cfg)
    jg_term_z = jax.jacfwd(lambda zz: ocp._terminal_local(zz, params, cfg))(zs[-1])
    # terminal-step acol tangents only (the full acol_x intermediate is
    # gone from the dense path — see the link-row reassociation above)
    acol_x_last = jnp.einsum("lij,jx->lix", acol[-1], dq_r[-1])
    dz_last = jnp.concatenate(
        [
            dq_r[-1], ddq_r[-1], du_r[-1], dp[-1], dv[-1],
            drs_traj[-1][None], ddrs[-1][None], dps_traj[-1][None],
            ddps[-1][None], ddsl,
            acol_x_last.reshape(NUM_LINK_SETS * 3, nx),
        ]
    )  # (N_Z, nx)
    jg_term = jg_term_z @ dz_last

    # ---- terminal residuals (affine + v[N-1]) ----
    slacks = params["slacks0"] + traj["dslacks"]
    r_term = jnp.concatenate(
        [
            jnp.sqrt(w[8]) * slacks[jnp.array([0, 1, 2, 3, 5])],
            jnp.sqrt(w[10]) * traj["dslacks"],
            jnp.sqrt(jnp.asarray(100.0, dtype)) * traj["v"][n - 1],
        ]
    )
    jr_term = jnp.concatenate(
        [
            jnp.sqrt(w[8]) * ddsl[jnp.array([0, 1, 2, 3, 5])],
            jnp.sqrt(w[10]) * ddsl,
            jnp.sqrt(jnp.asarray(100.0, dtype)) * dv[-1],
        ]
    )

    g_tail = st.tail_values(traj, dtype, cfg.robot)

    residuals = jnp.concatenate([r_steps.reshape(-1), r_term])
    j_res = jnp.concatenate([jr_steps.reshape(-1, nx), jr_term])

    if cfg.struct_link:
        # factored-link mode: the 1260 link rows never materialize as a
        # dense Jacobian block — `ocp_struct.link_*` applies them through
        # (A_l @ acol_u) inside the QP. Constraint rows are REORDERED to
        # [dense runtime (set/band/phi/term) | link | static tail]; every
        # consumer of g is order-free (merit/viol sums) or split-aware.
        gs = g_steps.reshape(n - 1, st.per_step_g)
        g_dense = jnp.concatenate(
            [gs[:, :21].reshape(-1), gs[:, 111], g_term]
        )
        g_link = gs[:, 21:111].reshape(-1)
        constraints = jnp.concatenate([g_dense, g_link, g_tail])
        jg_dense = jnp.concatenate(
            [
                jnp.concatenate([jg_set, jg_band], axis=1).reshape(-1, nx),
                jg_nl[:, 21, :],
                jg_term,
            ]
        )
        acol_x = jnp.einsum("klij,kjx->klix", acol, dq_r)  # (n-1, 6, 3, nx)
        acol_u = acol_x[:, :, :, : NJ * (n - 1)]  # u-column support only
        return residuals, constraints, j_res, jg_dense, acol_u

    constraints = jnp.concatenate([g_steps.reshape(-1), g_term, g_tail])
    j_run = jnp.concatenate([jg_steps.reshape(-1, nx), jg_term])
    if not cfg.struct_tail:
        # materialize the static rows back into a dense constraint matrix
        # (isolates the 12-tangent AD win from the structural-tail QP)
        j_run = jnp.concatenate(
            [j_run, jnp.asarray(_static_bound_rows(n, cfg.dt), dtype)]
        )
    return residuals, constraints, j_res, j_run
