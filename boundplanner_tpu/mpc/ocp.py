"""The BoundMPC optimal control problem, condensed onto the jerk sequence.

Accelerator-first re-design of the reference NLP
(`bound_planner/BoundMPC/casadi_ocp_formulation.py:13-421`). The reference
keeps all states as decision variables (44N+6 = 666 vars) with the jerk-chain
dynamics as equality constraints and hands the sparse NLP to Ipopt. Here
we exploit that those dynamics (`casadi_ocp_formulation.py:106-164`) are
*explicit linear recursions*: the joint states (q, dq, ddq) are affine in the
jerk sequence, the pose states are explicit nonlinear functions of them
(p = fk(q), v = J(q) dq, trapezoidal integrated omega). Condensing out the
states leaves an equality-free NLP in

    x = [u_1..u_{N-1} (98) | dslacks (6) | rs0 (1) | drs (N) | ps0 (1) | dps (N)]

of dimension 136 with ~2.4k *inequality* rows — a dense Gauss-Newton
problem whose linear algebra is all matmuls + small Cholesky: dense,
fixed-shape, and trivially batched over scenes with ``vmap``.

The objective is written exactly as a sum of squared residuals (including
the smooth-one-norm path term via a square-root residual), so the
Gauss-Newton Hessian approximation reproduces the full cost curvature of
the reference objective (`casadi_ocp_formulation.py:266-299`,
`bound_mpc_functions.py:393-428`).
"""

from __future__ import annotations

import functools
from typing import Dict, NamedTuple

import jax
import jax.numpy as jnp

from ..config import MPCParams, MPC_SET_ROWS, NUM_LINK_SETS
from ..robot import kinematics as kin
from ..robot.model import DDQ_LIM, U_MAX, U_MIN, ocp_limits
from ..path import ref_fns

NJ = 7


def n_vars(n: int) -> int:
    return NJ * (n - 1) + 6 + 1 + n + 1 + n


class Decision(NamedTuple):
    u: jax.Array        # (N, 7) full jerk sequence (u[0] = measured jerk)
    dslacks: jax.Array  # (6,)
    rslacks: jax.Array  # (N,)
    drs: jax.Array      # (N,)
    pslacks: jax.Array  # (N,)
    dps: jax.Array      # (N,)


def unpack(x, u0, n: int) -> Decision:
    """Split the condensed decision vector; reconstruct the trapezoid slack
    trajectories (ref `casadi_ocp_formulation.py:135-141,159-164`)."""
    dt_idx = 0
    u_free = x[: NJ * (n - 1)].reshape(n - 1, NJ)
    u = jnp.concatenate([u0[None, :], u_free], axis=0)
    o = NJ * (n - 1)
    dslacks = x[o : o + 6]
    rs0 = x[o + 6]
    drs = x[o + 7 : o + 7 + n]
    ps0 = x[o + 7 + n]
    dps = x[o + 8 + n : o + 8 + 2 * n]
    return u, dslacks, rs0, drs, ps0, dps


def slack_trajectories(rs0, drs, ps0, dps, dt):
    """Trapezoidal integration of the slack rates (ref `:135-141`)."""
    incr_r = 0.5 * dt * (drs[:-1] + drs[1:])
    rslacks = rs0 + jnp.concatenate([jnp.zeros(1, drs.dtype), jnp.cumsum(incr_r)])
    incr_p = 0.5 * dt * (dps[:-1] + dps[1:])
    pslacks = ps0 + jnp.concatenate([jnp.zeros(1, dps.dtype), jnp.cumsum(incr_p)])
    return rslacks, pslacks


@functools.lru_cache(maxsize=None)
def jerk_chain_profiles(n: int, dt: float):
    """Scalar impulse responses of the jerk-spline chain (numpy,
    (n, n) each for q/dq/ddq): the dynamics
    (`casadi_ocp_formulation.py:106-120`) are LTI per joint, so the whole
    joint trajectory is ``free response + C @ u``."""
    import numpy as np

    cq = np.zeros((n, n))
    cdq = np.zeros((n, n))
    cddq = np.zeros((n, n))
    for m in range(n):
        u = np.zeros(n)
        u[m] = 1.0
        q = dq = ddq = 0.0
        for k in range(n - 1):
            q, dq, ddq = (
                q + dt * dq + dt**2 / 2 * ddq + dt**3 / 8 * u[k] + dt**3 / 24 * u[k + 1],
                dq + dt * ddq + dt**2 / 3 * u[k] + dt**2 / 6 * u[k + 1],
                ddq + dt / 2 * (u[k] + u[k + 1]),
            )
            cq[k + 1, m] = q
            cdq[k + 1, m] = dq
            cddq[k + 1, m] = ddq
    return cq, cdq, cddq


def rollout_joints(u, q0, dq0, ddq0, dt, static: bool = False):
    """Joint-space rollout of the jerk-spline chain — exactly the reference
    dynamics (`casadi_ocp_formulation.py:106-120`): affine in u.

    ``static`` evaluates the closed form (free response + impulse-response
    matmuls) instead of the sequential scan. Not adopted: slower than the
    scan inside the fused tick in earlier measurements (the scan's 14
    elementwise steps fuse into cheap (batch, 7) ops). Kept with its tests
    (same arithmetic up to reassociation)."""
    if static:
        n = u.shape[0]
        dtype = u.dtype
        cq, cdq, cddq = jerk_chain_profiles(n, float(dt))
        t = dt * jnp.arange(n, dtype=dtype)[:, None]
        q = (
            q0[None] + t * dq0[None] + 0.5 * t * t * ddq0[None]
            + jnp.asarray(cq, dtype) @ u
        )
        dq = dq0[None] + t * ddq0[None] + jnp.asarray(cdq, dtype) @ u
        ddq = ddq0[None] + jnp.asarray(cddq, dtype) @ u
        return q, dq, ddq

    def step(carry, uk_pair):
        q, dq, ddq = carry
        u_k, u_k1 = uk_pair
        q_n = q + dt * dq + dt**2 / 2.0 * ddq + dt**3 / 8.0 * u_k + dt**3 / 24.0 * u_k1
        dq_n = dq + dt * ddq + dt**2 / 3.0 * u_k + dt**2 / 6.0 * u_k1
        ddq_n = ddq + dt / 2.0 * (u_k + u_k1)
        return (q_n, dq_n, ddq_n), (q_n, dq_n, ddq_n)

    pairs = (u[:-1], u[1:])
    _, (qs, dqs, ddqs) = jax.lax.scan(step, (q0, dq0, ddq0), pairs)
    q = jnp.concatenate([q0[None], qs])
    dq = jnp.concatenate([dq0[None], dqs])
    ddq = jnp.concatenate([ddq0[None], ddqs])
    return q, dq, ddq


def rollout_cartesian(q, dq, p0, v0, dt, chain=None):
    """Pose/twist trajectories from the joint rollout: p_pos = fk(q),
    v = J(q) dq, integrated omega by trapezoid (ref `:121-133`).
    ``chain`` selects the robot (`kin.chain_by_name`; the reference's
    USE_IIWA switch reaches the OCP through the symbolic FK it loads,
    `RobotModel.py:18-21`)."""
    jacs = jax.vmap(lambda qq: kin.jacobian_fk(qq, chain))(q[1:])  # (N-1, 6, 7)
    v_rest = jnp.einsum("kij,kj->ki", jacs, dq[1:])     # (N-1, 6)
    v = jnp.concatenate([v0[None], v_rest])
    p_pos_rest = jax.vmap(lambda qq: kin.fk_pos(qq, chain))(q[1:])
    p_pos = jnp.concatenate([p0[None, :3], p_pos_rest])
    omega = v[:, 3:]
    incr = 0.5 * dt * (omega[:-1] + omega[1:])
    iw = p0[3:] + jnp.concatenate(
        [jnp.zeros((1, 3), q.dtype), jnp.cumsum(incr, axis=0)]
    )
    p = jnp.concatenate([p_pos, iw], axis=1)
    return p, v


def rollout(x, params, cfg: MPCParams):
    n = cfg.n
    u, dslacks, rs0, drs, ps0, dps = unpack(x, params["u0"], n)
    q, dq, ddq = rollout_joints(u, params["q0"], params["dq0"], params["ddq0"], cfg.dt)
    p, v = rollout_cartesian(
        q, dq, params["p0"], params["v0"], cfg.dt, kin.chain_by_name(cfg.robot)
    )
    rslacks, pslacks = slack_trajectories(rs0, drs, ps0, dps, cfg.dt)
    return {
        "u": u,
        "q": q,
        "dq": dq,
        "ddq": ddq,
        "p": p,
        "v": v,
        "dslacks": dslacks,
        "rslacks": rslacks,
        "drs": drs,
        "pslacks": pslacks,
        "dps": dps,
    }


# --------------------------------------------------------------------------
# Per-step local evaluation over a packed input vector z.
#
# z packs everything step k's residuals/constraints depend on:
#   [ q_k(7) | dq_k(7) | u_k(7) | p_k(6) | v_k(6) | rs_k | drs_k | ps_k |
#     dps_k | dslacks(6) | p_col_k(6x3 flat) ]  -> dim 61
#
# This factoring serves double duty: `evaluate` vmaps `_step_local` over
# the horizon (same graph as before), and the manual-chain-rule Jacobian
# (`ocp_jac.evaluate_with_jac`) differentiates `_step_local` w.r.t. z
# (61 tangents through the reference/error math only — the FK and the
# affine state recursions are handled by per-step 7-tangent bundles and
# static sensitivity matrices).
# --------------------------------------------------------------------------

N_Z = 61


def pack_z(q_k, dq_k, u_k, p_k, v_k, rs_k, drs_k, ps_k, dps_k, dslacks, p_col_k):
    return jnp.concatenate(
        [
            q_k,
            dq_k,
            u_k,
            p_k,
            v_k,
            rs_k[None],
            drs_k[None],
            ps_k[None],
            dps_k[None],
            dslacks,
            p_col_k.reshape(-1),
        ]
    )


def unpack_z(z):
    return {
        "q": z[0:7],
        "dq": z[7:14],
        "u": z[14:21],
        "p": z[21:27],
        "v": z[27:33],
        "rs": z[33],
        "drs": z[34],
        "ps": z[35],
        "dps": z[36],
        "dslacks": z[37:43],
        "p_col": z[43:61].reshape(NUM_LINK_SETS, 3),
    }


def _ref_err_of_z(k, zd, params, n: int, nr_segs: int):
    win = {
        "p_ref": params["p_ref"],
        "dp_ref": params["dp_ref"],
        "dp_normed": params["dp_normed"],
        "phi_switch": params["phi_switch"],
        "bp1": params["bp1"],
        "bp2": params["bp2"],
        "br1": params["br1"],
        "br2": params["br2"],
        "e_r_bound": params["e_r_bound"],
        "a_set": params["a_set"],
        "b_set": params["b_set"],
        "v1": params["v1"],
        "v2": params["v2"],
        "v3": params["v3"],
    }
    ref = ref_fns.reference_function(
        win, params["split_idx"], k, zd["p"], zd["v"], n, nr_segs
    )
    err = ref_fns.error_function(
        ref, params, params["split_idx"], k, zd["p"], zd["v"],
        params["p0"][3:], n, nr_segs,
    )
    return ref, err


def _step_local(k, z, params, cfg: MPCParams):
    """Residuals and constraint rows of horizon step k from the packed
    local inputs z (ref `casadi_ocp_formulation.py:266-334` +
    `bound_mpc_functions.py:393-424` with sqrt-weights folded in)."""
    n, nr_segs = cfg.n, cfg.nr_segs
    w = params["weights"]
    zd = unpack_z(z)
    slacks = params["slacks0"] + zd["dslacks"]
    ref, err = _ref_err_of_z(k, zd, params, n, nr_segs)

    phi, dphi = ref["phi"], ref["dphi"]
    sigm = 1.0 / (1.0 + jnp.exp(-60.0 * (phi - (params["phi_max"] - 0.05))))
    v_orth = zd["v"] - dphi * ref["dp_d"]
    one_norm = ref_fns.approx_one_norm(params["x_phi_d"][0] - phi)
    # Row order within the step block: the 26 (p, v)-NONLINEAR rows first
    # (matching `ocp_jac._step_nl` exactly), then the 14 x-affine rows.
    # The objective is sum r^2 and every consumer reduces over the step
    # block order-invariantly (J^T r, Gram), so this is a pure layout
    # choice — it lets `evaluate_with_jac_structured` assemble jr_steps
    # as [jr_nl | static affine block] in one fusable concat instead of
    # four interleaved splices. The reference keeps cost terms in
    # formulation order (`casadi_ocp_formulation.py:266-334`); order is
    # semantically free there too.
    r = jnp.concatenate(
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
            jnp.sqrt(w[6]) * zd["dq"][2:5],
            jnp.sqrt(w[7]) * zd["u"],
            jnp.sqrt(w[9]) * zd["rs"][None],
            jnp.sqrt(w[10]) * zd["drs"][None],
            jnp.sqrt(w[9]) * zd["ps"][None],
            jnp.sqrt(w[10]) * zd["dps"][None],
        ]
    )

    rows = []
    # EE position inside the current convex set (15)
    rows.append(ref["a_current"] @ zd["p"][:3] - ref["b_current"] - zd["ps"])
    # orientation bands (3 upper + 3 lower)
    proj1 = jnp.dot(ref["br1_current"], err["e_r_orth1"])
    proj_par = jnp.dot(ref["dp_normed_d"], err["e_r_par"])
    proj2 = jnp.dot(ref["br2_current"], err["e_r_orth2"])
    projs = jnp.stack([proj1, proj_par, proj2])
    rows.append(projs - ref["r_bound_upper"] - zd["rs"])
    rows.append(ref["r_bound_lower"] - projs - zd["rs"])
    # 6 link collision sets at q_k (ref `:323-331` uses q[k]) (90)
    link_rows = (
        jnp.einsum("lri,li->lr", params["a_set_joints"], zd["p_col"])
        - params["b_set_joints"]
        - slacks[:NUM_LINK_SETS, None]
    )
    rows.append(link_rows.reshape(-1))
    # phi within current segment (1)
    rows.append((ref["phi"] - (ref["phi_end_seg"] + 0.005))[None])
    return r, jnp.concatenate(rows)


def _terminal_local(z, params, cfg: MPCParams):
    """Terminal set/rotation constraint rows at k = N-1
    (ref `casadi_ocp_formulation.py:337-380`)."""
    n, nr_segs = cfg.n, cfg.nr_segs
    kf = n - 1
    zd = unpack_z(z)
    slacks = params["slacks0"] + zd["dslacks"]
    ref_f, err_f = _ref_err_of_z(kf, zd, params, n, nr_segs)
    s_f = ref_fns.segment_index(kf, params["split_idx"], nr_segs)
    p_end = params["p_ref"][s_f + 1][:3]
    bnew = ref_f["b_next"] - ref_f["a_next"] @ p_end
    anew = ref_f["a_next"] @ jnp.stack(
        [ref_f["bp1_current"], ref_f["bp2_current"]], axis=1
    )
    z_proj = jnp.stack(
        [
            jnp.dot(ref_f["bp1_current"], err_f["e_p"]),
            jnp.dot(ref_f["bp2_current"], err_f["e_p"]),
        ]
    )
    g_term_set = anew @ z_proj - bnew - slacks[-1]

    proj1n = jnp.dot(ref_f["br1_next"], err_f["e_r_orth1"])
    proj_parn = jnp.dot(ref_f["dp_normed_n"], err_f["e_r_par"])
    proj2n = jnp.dot(ref_f["br2_next"], err_f["e_r_orth2"])
    projs_n = jnp.stack([proj1n, proj_parn, proj2n])
    g_term_rot_u = projs_n - ref_f["r_bound_upper_next"] - slacks[-1]
    g_term_rot_l = ref_f["r_bound_lower_next"] - projs_n - slacks[-1]
    return jnp.concatenate([g_term_set, g_term_rot_u, g_term_rot_l])


def local_inputs(traj, n: int, chain=None):
    """Packed z vectors for steps k = 1..N-1: (N-1, N_Z). The collision
    frame positions are computed here (outside `_step_local`) so the
    Jacobian path can chain them through dfk_col/dq."""
    p_col = jax.vmap(lambda qq: kin.fk_pos_col_all(qq, chain))(
        traj["q"][1:]
    )[:, :NUM_LINK_SETS]
    dsl = jnp.broadcast_to(traj["dslacks"], (n - 1, 6))
    return jax.vmap(pack_z)(
        traj["q"][1:],
        traj["dq"][1:],
        traj["u"][1:],
        traj["p"][1:],
        traj["v"][1:],
        traj["rslacks"][1:],
        traj["drs"][1:],
        traj["pslacks"][1:],
        traj["dps"][1:],
        dsl,
        p_col,
    )


def evaluate(x, params, cfg: MPCParams):
    """Joint evaluation of objective residuals and inequality constraints.

    One rollout + one per-step reference/error sweep feeds both outputs —
    the graph is built once (matters doubly here: runtime, and compile
    time, which grows with program size).

    Residuals: cost = sum(r^2), mirroring `casadi_ocp_formulation.py:266-299`
    + `objective_function` (`bound_mpc_functions.py:393-424`) with
    sqrt-weights folded in. Constraints: all g(x) <= 0 rows of
    `casadi_ocp_formulation.py:301-380` plus the lbx/ubx variable bounds
    (`BoundMPC.py:544-589`).
    """
    n, nr_segs = cfg.n, cfg.nr_segs
    w = params["weights"]
    traj = rollout(x, params, cfg)
    dtype = x.dtype
    slacks = params["slacks0"] + traj["dslacks"]

    zs = local_inputs(traj, n, kin.chain_by_name(cfg.robot))
    ks = jnp.arange(1, n)
    r_steps, g_steps = jax.vmap(
        lambda k, z: _step_local(k, z, params, cfg)
    )(ks, zs)
    r_steps = r_steps.reshape(-1)
    g_steps = g_steps.reshape(-1)

    r_term = jnp.concatenate(
        [
            jnp.sqrt(w[8]) * slacks[jnp.array([0, 1, 2, 3, 5])],
            jnp.sqrt(w[10]) * traj["dslacks"],
            jnp.sqrt(jnp.asarray(100.0, dtype)) * traj["v"][n - 1],
        ]
    )
    residuals = jnp.concatenate([r_steps, r_term])

    # --- terminal constraints at k = N-1 (ref `:337-380`) ---
    g_term = _terminal_local(zs[-1], params, cfg)

    # --- state bounds for k=1..N-1 (lbx/ubx in the reference) ---
    dtype = x.dtype
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
    # --- slack nonnegativity (lbx >= 0 on all slack variables) ---
    g_slack = jnp.concatenate(
        [
            -traj["dslacks"],
            -traj["rslacks"],
            -traj["drs"],
            -traj["pslacks"],
            -traj["dps"],
        ]
    )

    constraints_all = jnp.concatenate([g_steps, g_term, g_bounds, g_slack])
    return residuals, constraints_all


def cost_residuals(x, params, cfg: MPCParams):
    return evaluate(x, params, cfg)[0]


def cost(x, params, cfg: MPCParams):
    r = cost_residuals(x, params, cfg)
    return jnp.sum(r * r)


def constraints(x, params, cfg: MPCParams):
    return evaluate(x, params, cfg)[1]


def n_constraints(cfg: MPCParams) -> int:
    n = cfg.n
    per_step = MPC_SET_ROWS + 6 + NUM_LINK_SETS * MPC_SET_ROWS + 1
    return (
        (n - 1) * per_step
        + MPC_SET_ROWS
        + 6
        + (n - 1) * NJ * 6
        + (n - 1) * NJ * 2
        + (6 + 4 * n)
    )


def shift_warm_start(x, cfg: MPCParams):
    """Advance a previous decision vector one control period for warm
    starting: jerk and slack-rate sequences shift left one step (last
    entry repeated), integrated slack offsets advance by one trapezoid
    increment. The reference warm-starts with the UNSHIFTED previous
    solution (`BoundMPC.py:412-428`); shifting aligns the guess with the
    receding horizon and typically starts the SQP closer to the optimum.
    """
    n = cfg.n
    dt = cfg.dt
    o = NJ * (n - 1)
    u = x[:o].reshape(n - 1, NJ)
    u_s = jnp.concatenate([u[1:], u[-1:]], axis=0)
    dslacks = x[o : o + 6]
    rs0 = x[o + 6]
    drs = x[o + 7 : o + 7 + n]
    ps0 = x[o + 7 + n]
    dps = x[o + 8 + n : o + 8 + 2 * n]
    rs0_s = rs0 + 0.5 * dt * (drs[0] + drs[1])
    ps0_s = ps0 + 0.5 * dt * (dps[0] + dps[1])
    drs_s = jnp.concatenate([drs[1:], drs[-1:]])
    dps_s = jnp.concatenate([dps[1:], dps[-1:]])
    return jnp.concatenate(
        [u_s.reshape(-1), dslacks, rs0_s[None], drs_s, ps0_s[None], dps_s]
    )
