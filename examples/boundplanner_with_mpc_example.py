"""Full planner + receding-horizon MPC loop — parity config 3 of
BASELINE.json (ref `boundplanner_with_mpc_example.py`)."""

import sys
import time
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation as R

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles

from boundplanner_tpu.mpc import MPCNode
from boundplanner_tpu.planner import BoundPlanner


GOAL_P = np.array([0.45, -0.5, 0.2])
GOAL_R = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()


def start_q():
    q0 = np.zeros(7)
    q0[3] = -np.pi / 2
    q0[5] = np.pi / 2
    return q0


def main(plot: bool = False, seed: int = 0, max_ticks: int = 200):
    """Plan, then run the MPC loop until the path end (or ``max_ticks``).
    Returns (executed EE positions, via points, the MPCNode)."""
    q0 = start_q()
    mpc_node = MPCNode(q0)
    mpc_node.step()

    p0fk, _, _ = mpc_node.robot_model.forward_kinematics(q0, 0 * q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1, r1 = GOAL_P, GOAL_R

    obstacles = example_obstacles()
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=WORKSPACE_MAX,
        workspace_min=WORKSPACE_MIN,
        seed=seed,
        verbose=True,
    )
    start = time.time()
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)
    print(f"Path planning took {time.time() - start:.2f}s")

    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1_list = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    e_r_bound = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
    mpc_node.update_reference(
        p_via, r_via, bp1_list, br1_list, e_r_bound, a_sets, b_sets, obstacles
    )

    traj = []
    ticks = 0
    while (
        float(mpc_node.mpc.phi_current[0]) < float(mpc_node.mpc.phi_max[0]) - 0.001
        and ticks < max_ticks
    ):
        mpc_node.step(verbose=True)
        traj.append(mpc_node.p_lie[:3].copy())
        ticks += 1

    traj = np.array(traj)
    goal_err = np.linalg.norm(traj[-1] - p1)
    print(f"Finished after {ticks} ticks; final EE error to goal: {goal_err*1000:.1f} mm")

    if plot:
        from boundplanner_tpu.viz import plot_via_path
        import matplotlib.pyplot as plt

        plot_via_path(p_via, r_via, sets_via, planner.obs_sets)
        plt.plot(traj[:, 0], traj[:, 1], traj[:, 2], linewidth=2, color="black")
        plt.show()
    return traj, p_via, mpc_node


if __name__ == "__main__":
    main(plot="--plot" in sys.argv)
