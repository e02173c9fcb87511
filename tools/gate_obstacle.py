"""CPU obstacle gate: plan around a table + box obstacle and track to the
goal with the MPCNode loop on the CPU backend (f32, perf config).

Adoption bar (recorded since round 1): reaches the goal in <= ~40 ticks,
0 infeasibility fallbacks, final position error ~1 mm, no collision of
the EE with the ORIGINAL (unexpanded) obstacle boxes on any tick.

Part of the standard solver-change gate set:
  1. this script (CPU)
  2. tools/gate_scene43.py (GPU marginal-scene replay)
  3. python bench.py 128 20 (GPU random-128 fleet quality + throughput)
  4. python bench.py 128 50 (GPU long-horizon fleet)
"""
import os
import jax; jax.config.update("jax_platforms", "cpu")  # noqa: E702
import sys; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # noqa: E501,E702

import numpy as np
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.mpc import MPCNode
from boundplanner_tpu.planner import BoundPlanner


def main():
    cfg = perf_mpc_params()
    q0 = np.zeros(7); q0[3] = -np.pi / 2; q0[5] = np.pi / 2  # noqa: E702
    node = MPCNode(q0, params=cfg)
    p0fk, _, _ = node.robot_model.forward_kinematics(q0, 0 * q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1 = np.array([0.45, -0.4, 0.25])
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    obstacles = [
        [0.2, -1.0, -0.1, 1.0, 1.0, 0.0],
        [0.35, -0.25, 0.0, 0.55, -0.1, 0.45],
    ]
    planner = BoundPlanner(
        e_p_max=0.5, obstacles=obstacles,
        workspace_max=[1.0, 0.38, 1.0], workspace_min=[-0.14, -1.0, 0.0],
        seed=0,
    )
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)
    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1 = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
    node.update_reference(p_via, r_via, bp1_list, br1, erb, a_sets, b_sets, obstacles)
    ticks = 0
    ok = True
    while (float(node.mpc.phi_current[0]) < float(node.mpc.phi_max[0]) - 0.001
           and ticks < 60):
        node.step()
        for a, b in planner.obs_sets_orig:
            if np.max(a @ node.p_lie[:3] - b) <= -1e-5:
                ok = False
        ticks += 1
    err = np.linalg.norm(node.p_lie[:3] - p1)
    print("ticks", ticks, "fallbacks", sum(node.fails),
          "final_mm", round(err * 1000, 3),
          "reached", float(node.mpc.phi_current[0]) > float(node.mpc.phi_max[0]) - 0.02,
          "no_collision", ok)


if __name__ == "__main__":
    main()
