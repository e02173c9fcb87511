"""Replanning flow: new obstacle appears mid-track -> replan -> hand-off.

Exercises the reference's recovery path (SURVEY.md §3.4:
`BoundPlanner.plan_convex_set_path(replanning=True, p_horizon=...)` +
`BoundMPC.update` + `MPCNode.update_reference`).
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu.mpc import MPCNode
from boundplanner_tpu.planner import BoundPlanner


@pytest.mark.slow
def test_replan_with_new_obstacle():
    q0 = np.zeros(7)
    q0[3] = -np.pi / 2
    q0[5] = np.pi / 2
    node = MPCNode(q0)

    p0fk, _, _ = node.robot_model.forward_kinematics(q0, 0 * q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1 = np.array([0.45, -0.4, 0.3])
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()

    obstacles = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0]]
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=[1.0, 0.38, 1.0],
        workspace_min=[-0.14, -1.0, 0.0],
        seed=0,
    )
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)

    def handoff(p_via, r_via, bp1_list, sets_via, obstacles):
        a_sets = [x[0] for x in sets_via]
        b_sets = [x[1] for x in sets_via]
        br1 = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
        erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
        node.update_reference(p_via, r_via, bp1_list, br1, erb, a_sets, b_sets, obstacles)

    handoff(p_via, r_via, bp1_list, sets_via, obstacles)
    for _ in range(6):
        node.step()
    phi_before = float(node.mpc.phi_current[0])
    assert phi_before > 0.01

    # a new obstacle appears ahead; replan from the current pose reusing the
    # committed horizon
    # placed ahead of the current EE position, not on top of it
    new_obstacles = obstacles + [[0.36, -0.42, 0.0, 0.5, -0.3, 0.22]]
    planner.add_obstacle_reps(new_obstacles, update=True, reset=True)
    p_now = node.p_lie[:3].copy()
    r_now = R.from_rotvec(np.array(node.p_lie[3:])).as_matrix()
    p_horizon = [row for row in node.traj.T[:, :3]] if node.traj is not None else [p_now]
    p_horizon = [np.asarray(p, float) for p in np.asarray(node.traj)[:3].T]
    p_via2, r_via2, bp1_2, sets_via2 = planner.plan_convex_set_path(
        p_now, p1, r_now, r1, replanning=True, p_horizon=p_horizon, new_obs=True
    )
    assert len(p_via2) >= 2
    handoff(p_via2, r_via2, bp1_2, sets_via2, new_obstacles)

    # phi was re-initialized by projection; continue tracking
    for _ in range(25):
        node.step()
        for ob in new_obstacles[1:]:
            a = np.vstack([np.eye(3), -np.eye(3)])
            b = np.concatenate([ob[3:], -np.asarray(ob[:3])])
            # small tolerance: constraints are slacked (ref
            # `casadi_ocp_formulation.py:82-101`) and the obstacle may
            # appear close to the committed horizon
            assert np.max(a @ node.p_lie[:3] - b) > -0.01, "EE deep in new obstacle"
        if float(node.mpc.phi_current[0]) >= float(node.mpc.phi_max[0]) - 0.02:
            break
    # reached (or nearly reached) the goal of the new plan
    assert float(node.mpc.phi_current[0]) > 0.5 * float(node.mpc.phi_max[0])


@pytest.mark.slow
def test_replan_warm_carry_first_tick_quality():
    """`BoundMPC.update(warm_carry=True)` (default) preserves the previous
    solution across a replan, like the reference keeps ``prev_solution``
    through `BoundMPC.update` (`BoundMPC.py:193-198,271-336,412-428`).
    A/B on the production iteration budget: the first post-replan solve
    from the carried warm start must be no worse than the cold start it
    replaces."""
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.config import MPCParams
    from boundplanner_tpu.demo import demo_scene
    from boundplanner_tpu.mpc.bound_mpc import BoundMPC
    from boundplanner_tpu.robot import kinematics as kin
    from boundplanner_tpu.utils.integration import integrate_jerk_step

    # perf iteration counts in f64 (where cold 3-iteration solves stall,
    # see tests/test_external_anchor.py) — the config the fix targets
    cfg = MPCParams(sqp_iters=3, qp_iters=5, qp_gondzio=1,
                    line_search_steps=4, warm_shift=True,
                    struct_ocp=True, struct_chunked=False)
    _, meas0, _, q0 = demo_scene(cfg, dtype=np.float64)
    pose0 = np.asarray(meas0["p0"], np.float64)
    r0 = R.from_rotvec(pose0[3:]).as_matrix()
    goal = pose0[:3] + np.array([0.0, -0.3, 0.0])
    common = dict(
        bp1=[np.array([0.0, 0.0, 1.0])],
        br1=[np.array([0.0, 0.0, 1.0])],
        e_r_bound=[np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180],
        a_sets=[np.zeros((15, 3))],
        b_sets=[np.ones(15)],
    )
    mpc = BoundMPC(
        [pose0[:3].copy(), goal], [r0, r0], common["bp1"], common["br1"],
        common["e_r_bound"], common["a_sets"], common["b_sets"],
        obstacles=[], p0=pose0, params=cfg,
    )

    # track 3 ticks so a real warm start exists
    q, dq, ddq = q0.astype(np.float64), np.zeros(7), np.zeros(7)
    jerk, qf = np.zeros(7), q.copy()
    for _ in range(3):
        pose = np.asarray(kin.fk_pose(jnp.asarray(q)))
        v0 = np.asarray(kin.jacobian_fk(jnp.asarray(q)) @ dq)
        traj, ref, _, _, _ = mpc.step(q, dq, ddq, pose, v0, jerk, qf)
        assert ref["success"]
        u0, u1 = traj["dddq"][:, 0], traj["dddq"][:, 1]
        q, dq, ddq = (np.asarray(a) for a in integrate_jerk_step(
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
            jnp.asarray(u0), jnp.asarray(u1), cfg.dt))
        jerk = np.asarray(u1)
        qf = traj["q"][:, -1]
    saved_carry = mpc.carry
    pose = np.asarray(kin.fk_pose(jnp.asarray(q)))
    v0 = np.asarray(kin.jacobian_fk(jnp.asarray(q)) @ dq)
    v6 = np.concatenate([v0[:3], v0[3:]])

    # replanned path: from the CURRENT pose to a shifted goal (the shape of
    # a real replan hand-off: first via at the current position)
    new_goal = goal + np.array([-0.05, -0.05, 0.05])
    new_vias = [pose[:3].copy(), new_goal]
    results = {}
    for warm in (True, False):
        mpc.carry = saved_carry
        mpc.update(
            new_vias, [r0, r0], common["bp1"], common["br1"],
            common["e_r_bound"], common["a_sets"], common["b_sets"],
            obstacles=[], v=v6, p0=pose, warm_carry=warm,
        )
        assert bool(np.asarray(mpc.carry.has_prev)) == warm
        _, ref, _, _, _ = mpc.step(q, dq, ddq, pose, v0, jerk, qf)
        results[warm] = (ref["success"], mpc.last_viol, mpc.last_cost)

    s_w, viol_w, cost_w = results[True]
    s_c, viol_c, cost_c = results[False]
    # warm must not be worse on any axis, and strictly better on at least
    # one (viol or cost) — the continuity payoff
    assert s_w >= s_c
    assert viol_w <= viol_c + 1e-12
    assert cost_w <= cost_c * (1.0 + 1e-6)
    assert (viol_w < viol_c - 1e-9) or (cost_w < cost_c * 0.999) or (s_w > s_c)
