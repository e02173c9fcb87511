"""RViz bringup — the analog of the reference's `launch/rviz.launch.py`.

The reference launches an RViz session plus the publisher nodes (ref
`launch/rviz.launch.py:1-66`); rclpy is not a hard dependency here, so
bringup is a plain script: plan the example scene, create the
`ros_compat.RosPublisher` (real rclpy publishers when ROS 2 is sourced,
payload-dict logging otherwise), register the Trajectory/MPCParams host
services, and stream markers / paths / joint states while the MPC tracks.

With ROS 2 + RViz:  ros2 run rviz2 rviz2   (frame `world`), then
                    JAX_PLATFORMS=cpu python examples/rviz_bringup.py
Headless:           same command — payloads are built and logged, no-op
                    publish (exercised by tests/test_ros_compat.py).
"""

import sys
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation as R

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles

from boundplanner_tpu.mpc import MPCNode
from boundplanner_tpu.planner import BoundPlanner
from boundplanner_tpu.robot import kinematics as kin
from boundplanner_tpu.robot.model import COL_JOINT_SIZES
from boundplanner_tpu.ros_compat import MpcHostServices, RosPublisher


def main(seed: int = 0, max_ticks: int = 30):
    q0 = np.zeros(7)
    q0[3] = -np.pi / 2
    q0[5] = np.pi / 2

    node = MPCNode(q0)
    pub = RosPublisher()
    services = MpcHostServices(node)
    if pub.ros is not None:  # real srv servers need the IDL package
        try:
            services.register(pub)
        except Exception as exc:  # pragma: no cover
            pub._log(f"srv registration skipped: {exc}")

    p0fk, _, _ = node.robot_model.forward_kinematics(q0, 0 * q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1 = np.array([0.45, -0.5, 0.2])
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()

    obstacles = example_obstacles()
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=WORKSPACE_MAX,
        workspace_min=WORKSPACE_MIN,
        seed=seed,
    )
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)

    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1 = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    erb = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
    services.trajectory(p_via, r_via, bp1_list, br1, erb, a_sets, b_sets, obstacles)

    # scene markers once (ref RvizTools.publish_sets / via points)
    pub.publish_sets(sets_via)
    pub.publish_via_points(p_via, r_via)
    obstacle_sets = [(a, b) for a, b in planner.obs_sets_orig]
    pub.publish_sets(obstacle_sets, color=(1.0, 0.0, 0.0), alpha=0.4)

    ticks = 0
    while (
        float(node.mpc.phi_current[0]) < float(node.mpc.phi_max[0]) - 0.001
        and ticks < max_ticks
    ):
        node.step()
        pub.publish_tick(node.telemetry.ticks[-1])
        pub.publish_joint_state(node.q)
        centers = np.asarray(kin.fk_pos_col_all(np.asarray(node.q, np.float64)))
        pub.publish_collision_spheres(centers, COL_JOINT_SIZES)
        ticks += 1
    print(
        f"rviz bringup: {ticks} ticks published, phi "
        f"{float(node.mpc.phi_current[0]):.3f} / {float(node.mpc.phi_max[0]):.3f}"
    )
    pub.shutdown()
    return ticks


if __name__ == "__main__":
    main()
