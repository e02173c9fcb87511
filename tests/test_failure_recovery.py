"""Solver-level failure detection and recovery (SURVEY.md §5.3).

The reference's resilience is solver-level: on an infeasible solve it
increments an error counter and replays the previous trajectory shifted in
time (`BoundMPC.py:617-645,728-733`). Here we force infeasibility with an
impossible convex set and check the fallback machinery."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

import jax
import jax.numpy as jnp

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc.bound_mpc import BoundMPC

Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])
CFG = MPCParams(sqp_iters=3, qp_iters=8, line_search_steps=3)


def make_mpc(a_sets, b_sets, p0, r0):
    p_via = [p0[:3].copy(), p0[:3] + np.array([0.0, -0.2, 0.0])]
    r_via = [r0, r0]
    bp1 = [np.array([0.0, 0.0, 1.0])]
    br1 = [np.array([0.0, 0.0, 1.0])]
    erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180]
    return BoundMPC(
        p_via, r_via, bp1, br1, erb, a_sets, b_sets, obstacles=[],
        p0=p0, params=CFG,
    )


def test_infeasible_solve_reuses_previous():
    from boundplanner_tpu.robot import kinematics as kin

    pose0 = np.array(kin.fk_pose(jnp.asarray(Q0)))
    r0 = R.from_rotvec(pose0[3:]).as_matrix()

    # feasible first: free set
    mpc = make_mpc([np.zeros((15, 3))], [np.ones(15)], pose0, r0)
    zeros = np.zeros(7)
    out1 = mpc.step(Q0, zeros, zeros, pose0, np.zeros(6), zeros)
    assert mpc.error_count == 0
    q_prev = out1[0]["q"].copy()

    # corrupt the joint measurement: NaNs flow through the whole rollout,
    # every constraint becomes NaN and the solve must be flagged failed
    bad_q0 = Q0.copy()
    bad_q0[2] = np.nan
    out2 = mpc.step(bad_q0, zeros, zeros, pose0, np.zeros(6), zeros)
    assert mpc.error_count == 1  # failure detected
    # fallback replays the previous accepted trajectory shifted by one step
    np.testing.assert_allclose(out2[0]["q"][:, 0], q_prev[:, 1], atol=1e-9)

    # recovery: feasible measurement again -> error count resets
    out3 = mpc.step(Q0, zeros, zeros, pose0, np.zeros(6), zeros)
    assert mpc.error_count == 0


def test_exhausted_fallback_brakes_to_rest():
    """Once error_count saturates the reusable-horizon shift (>= N-2),
    the tick must command the safe-stop braking jerk instead of replaying
    the stale last jerk columns forever (which integrates into a cubic
    runaway — observed as an absorbing divergence on a marginal fleet
    scene before the fix).

    The fault here is a persistent NaN joint measurement, which NO solve
    can recover from — since the round-3 in-scan re-anchor, a merely
    infeasible scene (e.g. an impossible convex set) is no longer
    persistently failing: the re-anchored cold solve eventually finds the
    slack-feasible optimum (slack activation counts as success, the
    reference's own bar `BoundMPC.py:613-617`) and the arm resumes
    degraded tracking instead of staying parked."""
    from boundplanner_tpu.robot import kinematics as kin
    from boundplanner_tpu.utils.integration import integrate_jerk_step

    pose0 = np.array(kin.fk_pose(jnp.asarray(Q0)))
    r0 = R.from_rotvec(pose0[3:]).as_matrix()

    mpc = make_mpc([np.zeros((15, 3))], [np.ones(15)], pose0, r0)

    q, dq, ddq = Q0.copy(), np.zeros(7), np.zeros(7)
    # give the arm real motion so a stale-jerk replay would run away
    dq[1] = 0.5
    jerk = np.zeros(7)
    # one good tick to establish a previous solution
    pose = np.array(kin.fk_pose(jnp.asarray(q)))
    jac = np.array(kin.jacobian_fk(jnp.asarray(q)))
    out = mpc.step(q, dq, ddq, pose, jac @ dq, jerk)[0]
    speeds = []
    for _ in range(42):
        pose = np.array(kin.fk_pose(jnp.asarray(q)))
        jac = np.array(kin.jacobian_fk(jnp.asarray(q)))
        bad_q = q.copy()
        bad_q[2] = np.nan  # persistent sensor fault: every solve fails
        out = mpc.step(bad_q, dq, ddq, pose, jac @ dq, jerk)[0]
        u0, u1 = out["dddq"][:, 0], out["dddq"][:, 1]
        q, dq, ddq = (np.asarray(x) for x in integrate_jerk_step(
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
            jnp.asarray(u0), jnp.asarray(u1), CFG.dt))
        jerk = u1
        speeds.append(float(np.linalg.norm(dq)))
    assert mpc.error_count >= CFG.n - 2  # fallback horizon exhausted
    # braked to (near) rest, no runaway
    assert speeds[-1] < 0.02, speeds[-5:]
    assert np.isfinite(q).all() and np.abs(q).max() < 10.0


def test_reanchor_projects_onto_nearest_window_segment():
    """A safe-stop that drifted into a LATER window segment
    must re-anchor onto THAT segment (projection over all nr_segs window
    segments + sector advance), not clamp to the end of segment 0 and
    track from a reference a full segment behind the true pose — mirrors
    the reference's full re-projection in `BoundMPC.update`
    (`BoundMPC.py:313-322`)."""
    from boundplanner_tpu.robot import kinematics as kin

    from boundplanner_tpu.robot.model import _ik_gauss_newton

    pose0 = np.array(kin.fk_pose(jnp.asarray(Q0)))
    r0 = R.from_rotvec(pose0[3:]).as_matrix()

    # two sectors: short segment 0 (len 0.05), segment 1 (len 0.3)
    p_via = [pose0[:3].copy(),
             pose0[:3] + np.array([0.0, -0.05, 0.0]),
             pose0[:3] + np.array([0.0, -0.35, 0.0])]
    r_via = [r0, r0, r0]
    z = np.array([0.0, 0.0, 1.0])
    erb = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180
    free = (np.zeros((15, 3)), np.ones(15))
    mpc = BoundMPC(
        p_via, r_via, [z, z], [z, z], [erb, erb],
        [free[0], free[0]], [free[1], free[1]],
        obstacles=[], p0=pose0, params=CFG,
    )

    # forge a parked state: fallback horizon exhausted, at rest, with a
    # previous solution — the ARM (consistent q via IK) sits 0.1 into
    # segment 1 (global phi 0.15)
    parked = pose0.copy()
    parked[1] -= 0.15
    q_park = np.asarray(_ik_gauss_newton(
        jnp.asarray(parked[:3]), jnp.asarray(r0), jnp.asarray(Q0)
    ))
    pose_park = np.array(kin.fk_pose(jnp.asarray(q_park)))
    np.testing.assert_allclose(pose_park[:3], parked[:3], atol=1e-5)
    mpc.carry = mpc.carry._replace(
        error_count=jnp.asarray(CFG.n - 2, jnp.int32),
        has_prev=jnp.asarray(True),
    )
    zeros = np.zeros(7)
    mpc.step(q_park, zeros, zeros, pose_park, np.zeros(6), zeros)

    assert int(mpc.carry.path.sector) == 1, "sector did not advance"
    # anchored phi ~= 0.15 (global), i.e. 0.1 into segment 1 — allow the
    # post-anchor solve to progress a little within the tick
    phi = float(mpc.carry.phi_current)
    assert 0.10 < phi < 0.30, phi


def test_reanchor_recovers_after_safe_stop():
    """Re-design: after the fallback horizon is
    exhausted and the arm has braked to rest, the tick re-anchors the
    path-progress state to the parked pose (projection onto the current
    segment, like the reference's replanning re-init `BoundMPC.py:313-322`)
    and cold-starts the solve. When the failure cause clears, tracking
    resumes instead of staying parked forever."""
    from boundplanner_tpu.robot import kinematics as kin
    from boundplanner_tpu.utils.integration import integrate_jerk_step

    pose0 = np.array(kin.fk_pose(jnp.asarray(Q0)))
    r0 = R.from_rotvec(pose0[3:]).as_matrix()

    # feasible path, free set. The path must be LONG relative to the
    # braking drift: a pose parked beyond the final segment's end
    # projects past the hard phi-cap row and is host-replanning
    # territory, not the in-scan re-anchor's.
    p_via = [pose0[:3].copy(), pose0[:3] + np.array([0.0, -1.0, 0.0])]
    r_via = [r0, r0]
    bp1 = [np.array([0.0, 0.0, 1.0])]
    erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180]
    mpc = BoundMPC(
        p_via, r_via, bp1, bp1, erb, [np.zeros((15, 3))], [np.ones(15)],
        obstacles=[], p0=pose0, params=CFG,
    )

    q, dq, ddq = Q0.copy(), np.zeros(7), np.zeros(7)
    jerk = np.zeros(7)

    def plant_step(out):
        nonlocal q, dq, ddq, jerk
        u0, u1 = out["dddq"][:, 0], out["dddq"][:, 1]
        q, dq, ddq = (np.asarray(x) for x in integrate_jerk_step(
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
            jnp.asarray(u0), jnp.asarray(u1), CFG.dt))
        jerk = u1

    # 2 good ticks to establish a previous solution and some motion
    for _ in range(2):
        pose = np.array(kin.fk_pose(jnp.asarray(q)))
        jac = np.array(kin.jacobian_fk(jnp.asarray(q)))
        out = mpc.step(q, dq, ddq, pose, jac @ dq, jerk)[0]
        plant_step(out)
    assert mpc.error_count == 0

    # transient sensor fault: NaN joint measurement for enough ticks to
    # exhaust the fallback horizon and brake to rest
    for _ in range(CFG.n + 12):
        pose = np.array(kin.fk_pose(jnp.asarray(q)))
        jac = np.array(kin.jacobian_fk(jnp.asarray(q)))
        bad_q = q.copy()
        bad_q[2] = np.nan
        out = mpc.step(bad_q, dq, ddq, pose, jac @ dq, jerk)[0]
        plant_step(out)
    assert mpc.error_count >= CFG.n - 2      # parked
    assert np.max(np.abs(dq)) < 0.1           # quasi-static

    # fault clears: the re-anchored cold solve must succeed and resume
    # (the park controller may first need a few ticks to crawl back inside
    # a joint limit overrun during blind braking)
    recovered_at = None
    phis = []
    for t in range(15):
        pose = np.array(kin.fk_pose(jnp.asarray(q)))
        jac = np.array(kin.jacobian_fk(jnp.asarray(q)))
        out = mpc.step(q, dq, ddq, pose, jac @ dq, jerk)[0]
        plant_step(out)
        if mpc.error_count == 0 and recovered_at is None:
            recovered_at = t
        if recovered_at is not None:
            phis.append(float(out["phi"][0]))
    assert recovered_at is not None, "never recovered from the parked state"
    assert mpc.error_count <= 1  # tracking, not parked
    # tracking resumed: path progress advances from the re-anchored phi
    assert phis[-1] > phis[0] - 1e-6
    assert np.isfinite(q).all()
