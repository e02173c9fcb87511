"""BoundMPC: receding-horizon error-bounded tracking MPC — fused device tick.

Re-design of the reference ``BoundMPC`` class
(`bound_planner/BoundMPC/BoundMPC.py:27-1040`). One fully jitted function
(``mpc_tick``) performs everything the reference does per control period:

  window advance -> per-segment initial rotation errors -> projection
  vectors -> per-link collision sets -> parameter assembly -> SQP solve
  (the Ipopt replacement) -> infeasibility fallback -> horizon telemetry ->
  rotation-reference integration -> segment-switch logic (with via-point
  snap correction) -> state carry update.

The tick is a pure function ``(carry, measurement) -> (carry, outputs)``:
batched over scenes with ``vmap``, rolled over time with ``lax.scan``,
sharded over a device mesh with ``shard_map`` (see ``parallel``).

Host-facing ``BoundMPC`` mirrors the reference API (``__init__``/``step``/
``update``) for single-scene use.
"""

from __future__ import annotations

import functools
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import MPCParams, NUM_LINK_SETS
from ..path import ref_fns
from ..path.reference_path import (
    PathState,
    build_path,
    path_advance,
    path_apply_via_correction,
    path_window,
)
from ..planner.set_finder import ObstacleArrays, build_obstacle_arrays
from ..robot import kinematics
from ..utils import so3
from . import ocp, prep
from .solver import solve_sqp

NJ = 7


class MPCCarry(NamedTuple):
    path: PathState
    split_idx: jax.Array     # (nr_segs+1,) int32
    switch: jax.Array        # () bool
    pr_ref: jax.Array        # (3,) integrated rotation reference (rotvec)
    iw_ref: jax.Array        # (3,) integrated omega reference
    phi_current: jax.Array   # ()
    dphi_current: jax.Array  # ()
    slacks0: jax.Array       # (6,)
    x_prev: jax.Array        # (n_x,)
    has_prev: jax.Array      # () bool
    error_count: jax.Array   # () int32
    prev_q: jax.Array        # (N, 7) previous accepted trajectory ...
    prev_dq: jax.Array
    prev_ddq: jax.Array
    prev_u: jax.Array        # (N, 7)
    prev_p: jax.Array        # (N, 6)
    prev_v: jax.Array        # (N, 6)
    prev_pslacks: jax.Array  # (N,)


def init_carry(path: PathState, p0, cfg: MPCParams, dtype=np.float64) -> MPCCarry:
    """Fresh carry at plan start (ref `BoundMPC.__init__:87-198` state init).

    Built entirely in numpy (transfer-only; no eager device ops)."""
    n = cfg.n
    nx = ocp.n_vars(n)
    dtype = np.dtype(dtype)
    p0 = np.asarray(p0, dtype)
    return MPCCarry(
        path=path,
        split_idx=np.asarray([0] + [n] * cfg.nr_segs, np.int32),
        switch=np.asarray(False),
        pr_ref=p0[3:].copy(),
        iw_ref=np.zeros(3, dtype),
        phi_current=np.asarray(0.0, dtype),
        dphi_current=np.asarray(0.0, dtype),
        slacks0=np.zeros(6, dtype),
        x_prev=np.zeros(nx, dtype),
        has_prev=np.asarray(False),
        error_count=np.asarray(0, np.int32),
        prev_q=np.zeros((n, NJ), dtype),
        prev_dq=np.zeros((n, NJ), dtype),
        prev_ddq=np.zeros((n, NJ), dtype),
        prev_u=np.zeros((n, NJ), dtype),
        prev_p=np.tile(p0[None, :], (n, 1)),
        prev_v=np.zeros((n, 6), dtype),
        prev_pslacks=np.zeros(n, dtype),
    )


init_carry_np = init_carry


def _win_with_proj(win, carry, p0_rot):
    """Initial rotation errors + dual projection vectors for the window
    (ref `BoundMPC.py:438-462`)."""
    nr_segs = win["br1"].shape[0]
    # segment-start rotation references: integrated pr_ref for segment 0,
    # via rotations for the rest (ref `:438-440`)
    prs = jnp.concatenate([carry.pr_ref[None, :], win["r_taud"][1:nr_segs]], axis=0)
    dtau, dtau_par, dtau_o1, dtau_o2 = jax.vmap(prep.compute_initial_rot_errors)(
        jnp.tile(p0_rot[None, :], (nr_segs, 1)),
        prs,
        win["dp_normed"],
        win["br1"],
        win["br2"],
    )
    v1, v2, v3, jac_l, jac_r = prep.orientation_projection_vectors(
        dtau, dtau_par, dtau_o1, dtau_o2, win["dp_normed"], win["br1"], win["br2"]
    )
    return dict(
        dtau_init=dtau,
        dtau_init_par=dtau_par,
        dtau_init_orth1=dtau_o1,
        dtau_init_orth2=dtau_o2,
        v1=v1,
        v2=v2,
        v3=v3,
        jac_dtau_l=jac_l,
        jac_dtau_r=jac_r,
    )


def build_tick_params(carry: MPCCarry, meas: dict, obs: ObstacleArrays, cfg: MPCParams):
    """Steps 1-4 of the tick: advance the window, prep rotation errors,
    shape the phi weights, build link collision sets, and assemble the
    OCP parameter dict (ref `BoundMPC.py:393-498,507-542`). Split out of
    `mpc_tick` so tests and tools can construct realistic OCP params."""
    n, nr_segs = cfg.n, cfg.nr_segs
    dtype = meas["q0"].dtype

    # 1) advance window if last tick requested a switch (ref `:393-399`)
    path = path_advance(carry.path, carry.switch)
    win = path_window(path, nr_segs)

    # 2) per-segment rotation errors + projection vectors
    proj = _win_with_proj(win, carry, meas["p0"][3:])

    # 3) phi shaping (ref `:464-478`)
    weights = jnp.asarray(np.asarray(cfg.weights), dtype)
    weights, x_phi_d, phi_max_c = prep.shape_phi_weights(
        weights, path.phi_max, carry.phi_current
    )

    # 4) per-link collision sets (ref `:480-498`)
    a_j, b_j = prep.link_collision_sets(meas["q0"], meas["qf"], obs, robot=cfg.robot)

    params = {
        "q0": meas["q0"],
        "dq0": meas["dq0"],
        "ddq0": meas["ddq0"],
        "p0": meas["p0"],
        "v0": meas["v0"],
        "u0": meas["u0"],
        "split_idx": carry.split_idx,
        "slacks0": carry.slacks0,
        "i_omega_ref_0": carry.iw_ref,
        "x_phi_d": x_phi_d,
        "phi_max": phi_max_c,
        "weights": weights,
        "phi_switch": win["phi_switch"],
        "p_ref": win["p_ref"],
        "dp_ref": win["dp_ref"],
        "dp_normed": win["dp_normed"],
        "bp1": win["bp1"],
        "bp2": win["bp2"],
        "br1": win["br1"],
        "br2": win["br2"],
        "e_r_bound": win["e_r_bound"],
        "a_set": win["a_set"],
        "b_set": win["b_set"],
        "a_set_joints": a_j,
        "b_set_joints": b_j,
        **proj,
    }
    return params, path, win, proj


@functools.partial(jax.jit, static_argnames=("cfg",))
def mpc_tick(carry: MPCCarry, meas: dict, obs: ObstacleArrays, cfg: MPCParams):
    """One control period. ``meas``: q0, dq0, ddq0, p0, v0, u0, qf."""
    n, nr_segs = cfg.n, cfg.nr_segs
    dtype = meas["q0"].dtype
    acc = 0.005  # in-set accuracy of the switching test (ref `BoundMPC.py:917`)

    # 0) in-scan re-anchor after safe-stop (re-design; round-3). The
    # reference's recovery for a persistently failing solve is operator
    # replanning through `BoundMPC.update` (`BoundMPC.py:271-336`), which
    # re-projects phi onto the path (`:313-322`). The fused tick gets the
    # same re-anchor WITHOUT leaving the scan: once the fallback horizon is
    # exhausted (safe-stop braking, step 6b) and the arm is at rest, reset
    # the path-progress state to the projection of the PARKED pose onto the
    # current window segment, clear the accumulated slacks/split state, and
    # cold-start the solve. A successful re-anchored solve resumes
    # tracking (error_count drops to 0 in step 6); a failing one keeps the
    # arm parked — braking and fallback semantics are untouched.
    deep_bar = cfg.deep_fail_ticks if cfg.deep_fail_ticks > 0 else n - 2
    deep_bar = min(deep_bar, n - 2)
    deep_prev = carry.error_count >= jnp.asarray(deep_bar, jnp.int32)
    # quasi-static is enough for the projection anchor; the braking
    # controller converges geometrically, so a tight threshold only delays
    # the re-anchor by ticks
    at_rest = jnp.max(jnp.abs(meas["dq0"])) < 0.1
    reanchor = deep_prev & at_rest & carry.has_prev
    # project the parked pose onto ALL nr_segs window segments and advance
    # the sector to the nearest before anchoring (a safe-stop
    # that drifted into a LATER window segment would otherwise re-anchor
    # up to a full segment behind the true pose and track from a stale
    # reference) — mirrors the reference's full re-projection in
    # `BoundMPC.update` (`BoundMPC.py:313-322`).
    win_p = path_window(carry.path, nr_segs)
    dp3 = win_p["dp_ref"][:, :3]                       # (S,3) unit tangents
    pr3 = win_p["p_ref"][:, :3]
    seg_ext = win_p["phi_switch"][1:] - win_p["phi_switch"][:-1]
    t_seg = jnp.sum((meas["p0"][None, :3] - pr3) * dp3, axis=1)
    t_seg = jnp.clip(t_seg, 0.0, seg_ext)
    d2 = jnp.sum((meas["p0"][None, :3] - pr3 - t_seg[:, None] * dp3) ** 2, 1)
    # window slots past the path's end are clipped duplicates — mask them
    valid = carry.path.sector + jnp.arange(nr_segs) <= carry.path.num_sectors
    seg_star = jnp.argmin(jnp.where(valid, d2, jnp.inf)).astype(jnp.int32)
    path_r = carry.path._replace(
        sector=jnp.where(reanchor, carry.path.sector + seg_star,
                         carry.path.sector)
    )
    win_r = path_window(path_r, nr_segs)
    # anchor clamped into segment 0's phi extent: a pose parked BEYOND the
    # window's end projects past the hard phi-cap row (`_step_nl`'s
    # phi <= phi_end_seg + 0.005), which no control can satisfy — that
    # case is host-replanning territory (`BoundMPC.update`), and clamping
    # at least keeps the weight shaping/warm start consistent
    phi_anchor = win_r["phi_switch"][0] + jnp.dot(
        meas["p0"][:3] - win_r["p_ref"][0][:3], win_r["dp_ref"][0][:3]
    )
    phi_anchor = jnp.clip(
        phi_anchor, win_r["phi_switch"][0], win_r["phi_switch"][1]
    )
    dphi_anchor = jnp.dot(meas["v0"][:3], win_r["dp_ref"][0][:3])
    pr_anchor = prep.integrate_rotation_reference(
        so3.matrix_to_rotvec(win_r["r_vias"][0]),
        win_r["dp_ref"][0][3:],
        win_r["phi_switch"][0],
        phi_anchor,
    )
    iw_anchor = win_r["p_ref"][0][3:] + (
        phi_anchor - win_r["phi_switch"][0]
    ) * win_r["dp_ref"][0][3:]
    split_reset = jnp.asarray([0] + [n] * nr_segs, jnp.int32)
    pick_anchor = lambda a, b: jnp.where(reanchor, a, b)
    carry = carry._replace(
        path=path_r,
        phi_current=pick_anchor(phi_anchor, carry.phi_current),
        dphi_current=pick_anchor(dphi_anchor, carry.dphi_current),
        pr_ref=pick_anchor(pr_anchor, carry.pr_ref),
        iw_ref=pick_anchor(iw_anchor, carry.iw_ref),
        slacks0=pick_anchor(jnp.zeros_like(carry.slacks0), carry.slacks0),
        split_idx=pick_anchor(split_reset, carry.split_idx),
        switch=carry.switch & ~reanchor,
    )

    params, path, win, proj = build_tick_params(carry, meas, obs, cfg)

    # 5) solve (warm start: previous decision vector, ref `:412-418`).
    # Re-anchored (parked) ticks warm-start UNSHIFTED from x_prev: the arm
    # is at rest, so the measurements are frozen and consecutive parked
    # ticks form one continued SQP — x_prev carries the parked iterate
    # across ticks even while unsuccessful (step 10), so each tick adds
    # sqp_iters more Gauss-Newton iterations instead of re-running the
    # same cold start to the same plateau (a cold 3-iteration solve stalls
    # at viol ~3e-3, above the 1e-4 success bar; measured round 3).
    x_warm = (
        ocp.shift_warm_start(carry.x_prev, cfg) if cfg.warm_shift
        else carry.x_prev
    )
    x0 = jnp.where(
        carry.has_prev,
        jnp.where(reanchor, carry.x_prev, x_warm),
        jnp.zeros_like(carry.x_prev),
    )
    sol = solve_sqp(x0, params, cfg)

    # 6) infeasibility fallback (ref `:619-645`)
    success = sol.success
    use_prev = (~success) & carry.has_prev
    error_count = jnp.where(
        success, 0, jnp.where(carry.has_prev, carry.error_count + 1, 0)
    ).astype(jnp.int32)

    traj_new = ocp.rollout(sol.x, params, cfg)
    shift = jnp.where(use_prev, jnp.minimum(error_count, n - 2), 0)
    gidx = jnp.clip(jnp.arange(n) + shift, 0, n - 1)

    def pick(new, old):
        sel = jnp.where(use_prev, old, new)
        return sel[gidx]

    q_out = pick(traj_new["q"], carry.prev_q)
    dq_out = pick(traj_new["dq"], carry.prev_dq)
    ddq_out = pick(traj_new["ddq"], carry.prev_ddq)
    u_out = pick(traj_new["u"], carry.prev_u)
    p_out = pick(traj_new["p"], carry.prev_p)
    v_out = pick(traj_new["v"], carry.prev_v)
    ps_out = pick(traj_new["pslacks"], carry.prev_pslacks)

    # 6b) safe-stop once the reusable horizon is exhausted. The reference
    # shifts its previous trajectory by error_count and would run out of
    # columns after N failures (`BoundMPC.py:728-733` — it assumes
    # recovery or operator replanning first); replaying the LAST jerk
    # columns forever integrates into a runaway (constant jerk ->
    # cubically growing joint state; observed as an absorbing divergence
    # on a marginal fleet scene). Re-design: when error_count saturates
    # the shift (>= N-2), command a saturated deadbeat braking jerk on
    # the MEASURED (dq, ddq) instead, bringing the arm to rest.
    from ..robot.model import U_MAX, ocp_limits

    q_lim_upper, q_lim_lower, _, _ = ocp_limits(cfg.robot)

    # gains: with plant step ddq' = ddq + dt u, dq' = dq + dt ddq +
    # dt^2/2 u, the state feedback u = -(b/dt) ddq - (a/dt^2) dq has
    # closed-loop eigenvalues inside the unit circle for (a, b) =
    # (0.5, 1.5) (a deadbeat-style pair like (1, 2) sits ON the circle
    # and chatters).
    # Round-3 addition: a position term pulling q back INSIDE the joint
    # limits (with margin) when braking overran them — a parked pose
    # outside a hard bound is unrecoverable by ANY solve (the horizon's
    # first steps inherit the violation through the bounded-jerk
    # dynamics), so the re-anchor (step 0) would retry forever. The term
    # is EXACTLY zero when q is within limits (clip(q) == q), keeping the
    # pure braking behavior there. Continuous-time poles of
    # s^3 + (1.5/dt)s^2 + (0.5/dt^2)s + (0.08/dt^3): Routh 1.5*0.5 > 0.08
    # -> stable crawl back into the box.
    deep = use_prev & (error_count >= deep_bar)
    if cfg.fallback_guard:
        # Fallback collision guard (round 5; EXCEEDS the reference, which
        # replays the stale plan blindly, `BoundMPC.py:728-733`): if the
        # REUSED horizon's near-term EE path would enter an obstacle box,
        # engage the safe-stop braking NOW instead of after
        # deep_fail_ticks more replays. Measured motive: on the CPU mesh
        # a backend-flipped failing scene's unchecked pre-brake replay
        # swept the executed EE 3.2 cm into a box. Only
        # the first 3 steps are checked — they are what can execute
        # before the deep bar engages anyway; a stale TAIL clipping a box
        # is recoverable and should not trigger a park. Point-in-box via
        # the H-rep: inside iff every row is negative.
        rows_g = (
            jnp.einsum("mri,ki->kmr", obs.a, p_out[1:4, :3])
            - obs.b[None]
        )
        pen_g = -jnp.max(rows_g, axis=-1)                    # (3, M)
        pen_g = jnp.where(obs.mask[None], pen_g, -jnp.inf)
        deep = deep | (use_prev & (jnp.max(pen_g) > 0.0))
    q_target = jnp.clip(
        meas["q0"],
        jnp.asarray(q_lim_lower, dtype) + 0.03,
        jnp.asarray(q_lim_upper, dtype) - 0.03,
    )
    # a corrupted q measurement (NaN sensor fault — the very failure that
    # can drive the tick here) must not poison the braking command:
    # position feedback needs a valid q, velocity-only braking does not
    pos_term = (0.08 / cfg.dt**3) * (q_target - meas["q0"])
    pos_term = jnp.where(jnp.isfinite(pos_term), pos_term, 0.0)
    u_stop = jnp.clip(
        pos_term
        - (1.5 / cfg.dt) * meas["ddq0"] - (0.5 / cfg.dt**2) * meas["dq0"],
        -U_MAX, U_MAX,
    ).astype(u_out.dtype)
    u_out = jnp.where(deep, jnp.broadcast_to(u_stop, u_out.shape), u_out)

    # 7) horizon telemetry: re-evaluate reference/errors at the committed
    #    trajectory (ref compute_return_data `:750-892`)
    ref_win = {
        k: win[k]
        for k in ("p_ref", "dp_ref", "dp_normed", "phi_switch", "bp1", "bp2", "br1", "br2", "e_r_bound", "a_set", "b_set")
    }
    ref_win.update({k: proj[k] for k in ("v1", "v2", "v3")})
    err_params = {
        "i_omega_ref_0": carry.iw_ref,
        "jac_dtau_l": proj["jac_dtau_l"],
        "jac_dtau_r": proj["jac_dtau_r"],
        "dtau_init": proj["dtau_init"],
        "dtau_init_par": proj["dtau_init_par"],
        "dtau_init_orth1": proj["dtau_init_orth1"],
        "dtau_init_orth2": proj["dtau_init_orth2"],
    }

    def telem(i):
        ref = ref_fns.reference_function(
            ref_win, carry.split_idx, i, p_out[i], v_out[i], n, nr_segs
        )
        err = ref_fns.error_function(
            ref, err_params, carry.split_idx, i, p_out[i], v_out[i],
            meas["p0"][3:], n, nr_segs,
        )
        e_rs = jnp.stack(
            [
                jnp.dot(err["e_r_orth1"], ref["br1_current"]),
                jnp.dot(err["e_r_par"], ref["dp_normed_d"]),
                jnp.dot(err["e_r_orth2"], ref["br2_current"]),
            ]
        )
        e_rsn = jnp.stack(
            [
                jnp.dot(err["e_r_orth1n"], ref["br1_next"]),
                jnp.dot(err["e_r_parn"], ref["dp_normed_n"]),
                jnp.dot(err["e_r_orth2n"], ref["br2_next"]),
            ]
        )
        return {
            "phi": ref["phi"],
            "dphi": ref["dphi"],
            "p_d": ref["p_d"],
            "dp_d": ref["dp_d"],
            "e_p": err["e_p"],
            "e_r": err["e_r"],
            "e_rs": e_rs,
            "e_rsn": e_rsn,
            "r_lo": ref["r_bound_lower"],
            "r_up": ref["r_bound_upper"],
            "r_lo_n": ref["r_bound_lower_next"],
            "r_up_n": ref["r_bound_upper_next"],
        }

    tel = jax.vmap(telem)(jnp.arange(n))
    phis = tel["phi"]
    dphis = tel["dphi"]

    # 8) rotation-reference integration (ref `:894-914`)
    cond_sw1 = carry.split_idx[1] == 1
    base_r = jnp.where(cond_sw1, win["r_vias"][1], win["r_vias"][0])
    base_rv = so3.matrix_to_rotvec(base_r)
    seg = jnp.where(cond_sw1, 1, 0)
    pr_ref_new = prep.integrate_rotation_reference(
        base_rv, win["dp_ref"][seg][3:], win["phi_switch"][seg], phis[1]
    )
    iw_ref_new = win["p_ref"][seg][3:] + (phis[1] - win["phi_switch"][seg]) * win["dp_ref"][seg][3:]

    # 9) segment-switch update (ref `:916-1022`)
    split = carry.split_idx
    switch = jnp.asarray(False)
    steps = jnp.arange(n)
    for i in range(1, nr_segs - 1):
        lt = split[i] < n
        dec = split[i] - 1
        b1_switch = dec == 0
        split_b1 = jnp.where(b1_switch, n, dec)

        d0 = jnp.max(
            jnp.einsum("rj,kj->rk", win["a_set"][i - 1], p_out[:, :3])
            - win["b_set"][i - 1][:, None],
            axis=0,
        )
        d1 = jnp.max(
            jnp.einsum("rj,kj->rk", win["a_set"][i], p_out[:, :3])
            - win["b_set"][i][:, None],
            axis=0,
        )
        in0 = d0 < acc + ps_out
        in1 = d1 < acc + ps_out
        lf = jnp.max(jnp.where(~in1, steps, -1))
        in1 = in1 & (steps > lf)
        dswitch = phis > win["phi_switch"][i] - 0.03
        tol5 = 5.0 * jnp.pi / 180.0
        in_rot = jnp.all(
            (tel["e_rs"] < tel["r_up"]) & (tel["e_rs"] > tel["r_lo"])
            & (tel["e_rsn"] < tel["r_up_n"] + tol5)
            & (tel["e_rsn"] > tel["r_lo_n"] - tol5),
            axis=1,
        )
        cand = dswitch & in0 & in1 & in_rot
        exists = jnp.any(cand)
        first = jnp.argmax(cand)
        not_at_end = (path.sector + (i - 1)) < path.num_sectors
        trigger = (~lt) & (error_count == 0) & exists & not_at_end

        # via-point snap correction (ref `:992-1011`)
        dp_i = win["dp_ref"][i][:3]
        pv = win["p_ref"][i][:3]
        corr = jnp.dot(p_out[first][:3] - pv, dp_i)
        pv_new = pv + corr * dp_i
        path_corr = path_apply_via_correction(path, i, pv_new, corr)
        path = jax.tree.map(
            lambda a, b: jnp.where(trigger, a, b), path_corr, path
        )

        new_split_i = first - 1
        b2_switch = new_split_i == 0
        split_val = jnp.where(
            lt, split_b1, jnp.where(trigger, new_split_i, split[i])
        ).astype(jnp.int32)
        switch = switch | (lt & b1_switch) | (trigger & b2_switch)
        split = split.at[i].set(split_val)

    # shift on switch (ref `:1014-1017`)
    split_shifted = jnp.concatenate(
        [split[:1], split[2:], jnp.asarray([n], jnp.int32)]
    )
    split = jnp.where(switch, split_shifted, split)
    # monotonicity repair (ref `:1019-1021`)
    for i in range(1, nr_segs):
        fix = split[i] <= split[i - 1]
        split = split.at[i].set(
            jnp.where(fix, jnp.minimum(n, split[i - 1] + 1), split[i]).astype(jnp.int32)
        )

    # 10) carry update
    slacks0_new = carry.slacks0 + traj_new["dslacks"]
    carry_new = MPCCarry(
        path=path,
        split_idx=split,
        switch=switch,
        pr_ref=pr_ref_new,
        iw_ref=iw_ref_new,
        phi_current=phis[1],
        dphi_current=dphis[1],
        slacks0=slacks0_new,
        # parked ticks carry the (possibly unsuccessful) iterate so the
        # continued-SQP warm start above keeps making progress. On an
        # ORDINARY failed tick, carry the SHIFTED warm start instead of
        # the raw stale solution: the plant replays the old plan one step
        # per failed tick (`pick` above, ref `BoundMPC.py:728-733`), so
        # the warm start must keep shifting with it — a warm start shifted
        # only once but used k failed ticks later is progressively
        # misaligned, and the resulting solve failures cascade (observed:
        # a single marginal-tick miss on the scene-43 replay parked the
        # whole run once the float noise of an unrelated change moved the
        # miss to a different tick).
        x_prev=jnp.where(
            success | reanchor,
            sol.x,
            jnp.where(carry.has_prev, x_warm, carry.x_prev),
        ),
        has_prev=carry.has_prev | success,
        error_count=error_count,
        prev_q=jnp.where(success, traj_new["q"], carry.prev_q),
        prev_dq=jnp.where(success, traj_new["dq"], carry.prev_dq),
        prev_ddq=jnp.where(success, traj_new["ddq"], carry.prev_ddq),
        prev_u=jnp.where(success, traj_new["u"], carry.prev_u),
        prev_p=jnp.where(success, traj_new["p"], carry.prev_p),
        prev_v=jnp.where(success, traj_new["v"], carry.prev_v),
        prev_pslacks=jnp.where(success, traj_new["pslacks"], carry.prev_pslacks),
    )

    outputs = {
        "q": q_out,
        "dq": dq_out,
        "ddq": ddq_out,
        "dddq": u_out,
        "p": p_out,
        "v": v_out,
        "phi": phis,
        "dphi": dphis,
        "p_ref": tel["p_d"],
        "e_p": tel["e_p"],
        "e_r": tel["e_r"],
        "e_rs": tel["e_rs"],
        "success": success,
        "cost": sol.cost,
        "viol": sol.viol,
        "sqp_iters": sol.iters,
        "switched": path.switched,
        "sector": path.sector,
        "phi_max": path.phi_max,
    }
    return carry_new, outputs


@functools.partial(jax.jit, static_argnames=("robot",))
def _cartesian_acc(q, dq, ddq, robot="iiwa14"):
    """True Cartesian acceleration a = J(q) ddq + dJ(q, dq) dq over a
    horizon of joint states (ref `RobotModel.py:233-251` Jacobian time
    variation; the reference never wires it into traj_data)."""
    chain = kinematics.chain_by_name(robot)

    def one(qi, dqi, ddqi):
        j = kinematics.jacobian_fk(qi, chain)
        dj = jax.jvp(lambda qq: kinematics.jacobian_fk(qq, chain), (qi,), (dqi,))[1]
        return j @ ddqi + dj @ dqi

    return jax.vmap(one)(q, dq, ddq)


class BoundMPC:
    """Host-facing single-scene wrapper mirroring the reference API
    (`BoundMPC.py:28-336`)."""

    def __init__(
        self,
        pos_points,
        rot_points,
        bp1,
        br1,
        e_r_bound,
        a_sets,
        b_sets,
        obstacles,
        p0=np.zeros(6),
        params: MPCParams | None = None,
        dtype=jnp.float64,
        cartesian_acc: bool = False,
    ):
        self.cfg = params or MPCParams()
        # opt-in: report TRUE Cartesian acceleration J ddq + dJ dq in
        # traj_data["a"] instead of the reference's vel alias
        # (`BoundMPC.py:734` assigns the velocity trajectory to acc)
        self.cartesian_acc = cartesian_acc
        self.dtype = dtype
        self.obs = build_obstacle_arrays(obstacles, size_increase=0.0)
        path = build_path(
            pos_points, rot_points, bp1, br1, e_r_bound, a_sets, b_sets,
            nr_segs=self.cfg.nr_segs,
        )
        self.carry = init_carry(path, p0, self.cfg, dtype)
        self.error_count = 0

    @property
    def phi_current(self):
        return np.asarray(self.carry.phi_current).reshape(1)

    @property
    def phi_max(self):
        return np.asarray(self.carry.path.phi_max).reshape(1)

    @property
    def dt(self):
        return self.cfg.dt

    def update(
        self,
        pos_points,
        rot_points,
        bp1,
        br1,
        e_r_bound,
        a_sets,
        b_sets,
        obstacles,
        v,
        p0=np.zeros(6),
        params: MPCParams | None = None,
        warm_carry: bool = True,
        spiral_blend: float = 0.0,
        spiral_sub: int = 4,
    ):
        """Replanning hand-off (ref `BoundMPC.update:271-336`).

        ``warm_carry`` preserves the previous solution across the replan —
        the reference keeps ``prev_solution``/duals through ``update`` so
        the first post-replan solve is warm (`BoundMPC.py:193-198,412-428`
        survive `:271-336`). It is sound here because the condensed
        decision vector is the JOINT-SPACE jerk sequence + slacks (path
        data enters only through parameters), and replanning keeps the
        committed horizon valid by construction
        (`BoundPlanner.py:231-276,706-729`): the old jerk plan remains a
        dynamically consistent warm start for the new scene. The previous
        accepted trajectory is kept too, so the fallback shift still has
        columns if the first post-replan solve fails. Measured A/B (CPU
        obstacle replan scenario, `tests/test_replanning.py` harness):
        first-post-replan solve cost/viol strictly better warm than cold.
        """
        cfg = params or self.cfg
        if warm_carry and cfg.n != self.cfg.n:
            warm_carry = False  # decision-vector size changed
        self.cfg = cfg
        self.obs = build_obstacle_arrays(obstacles, size_increase=0.0)
        path = build_path(
            pos_points, rot_points, bp1, br1, e_r_bound, a_sets, b_sets,
            nr_segs=cfg.nr_segs, spiral_blend=spiral_blend,
            spiral_sub=spiral_sub,
        )
        old = self.carry
        carry = init_carry(path, p0, cfg, self.dtype)
        if warm_carry:
            carry = carry._replace(
                x_prev=old.x_prev,
                has_prev=old.has_prev,
                prev_q=old.prev_q,
                prev_dq=old.prev_dq,
                prev_ddq=old.prev_ddq,
                prev_u=old.prev_u,
                prev_p=old.prev_p,
                prev_v=old.prev_v,
                prev_pslacks=old.prev_pslacks,
            )

        # phi re-initialization by projection (ref `:313-322`)
        p_via0 = np.asarray(pos_points[0], dtype=np.float64)
        dp0 = np.asarray(pos_points[1], dtype=np.float64) - p_via0
        dp0 = dp0 / np.linalg.norm(dp0)
        phi0 = float((np.asarray(p0[:3]) - p_via0) @ dp0)
        dphi0 = float(np.asarray(v[:3]) @ dp0)

        path_np = path
        pr_ref = prep.integrate_rotation_reference(
            jnp.asarray(so3.matrix_to_rotvec(jnp.asarray(rot_points[0]))),
            path_np.dr[0],
            0.0,
            jnp.asarray(phi0, self.dtype),
        )
        iw_ref = path_np.iw[0] + phi0 * path_np.dr[0]
        self.carry = carry._replace(
            phi_current=jnp.asarray(phi0, self.dtype),
            dphi_current=jnp.asarray(dphi0, self.dtype),
            pr_ref=pr_ref,
            iw_ref=iw_ref,
        )
        self.error_count = 0

    def step(self, q0, dq0, ddq0, p0, v0, jerk_current, qf=None):
        """One optimization step (ref `BoundMPC.step:388-676`). Returns
        (traj_data, ref_data, err_data, t_solve, sqp_iters)."""
        if qf is None:
            qf = q0
        to = lambda x: jnp.asarray(np.asarray(x), self.dtype)
        meas = {
            "q0": to(q0),
            "dq0": to(dq0),
            "ddq0": to(ddq0),
            "p0": to(p0),
            "v0": to(v0),
            "u0": to(jerk_current),
            "qf": to(qf),
        }
        t0 = time.perf_counter()
        self.carry, out = mpc_tick(self.carry, meas, self.obs, self.cfg)
        out = jax.tree.map(np.asarray, out)
        t_solve = time.perf_counter() - t0
        self.error_count = int(self.carry.error_count)
        self.last_cost = float(out["cost"])
        self.last_viol = float(out["viol"])

        traj_data = {
            "q": out["q"][1:].T,
            "dq": out["dq"][1:].T,
            "ddq": out["ddq"][1:].T,
            "dddq": out["dddq"].T,
            "p": out["p"][1:].T,
            "v": out["v"][1:].T,
            # the reference aliases acc to vel (`BoundMPC.py:734`); kept for
            # API parity unless cartesian_acc=True requests the true value
            "a": (
                np.asarray(
                    _cartesian_acc(
                        jnp.asarray(out["q"][1:]),
                        jnp.asarray(out["dq"][1:]),
                        jnp.asarray(out["ddq"][1:]),
                        robot=self.cfg.robot,
                    )
                ).T
                if self.cartesian_acc
                else out["v"][1:].T
            ),
            "phi": out["phi"][1:],
            "dphi": out["dphi"][1:],
        }
        ref_data = {"p": out["p_ref"], "success": bool(out["success"])}
        err_data = {"e_p": out["e_p"], "e_r": out["e_r"], "e_rs": out["e_rs"]}
        return traj_data, ref_data, err_data, t_solve, int(out["sqp_iters"])
