"""Planner-only example — parity config 1 of BASELINE.json
(ref `boundplanner_example.py`)."""

import sys
import time
from pathlib import Path

import numpy as np
from scipy.spatial.transform import Rotation as R

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from examples.scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles

from boundplanner_tpu.planner import BoundPlanner


def main(plot: bool = False, seed: int = 0):
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=example_obstacles(),
        workspace_max=WORKSPACE_MAX,
        workspace_min=WORKSPACE_MIN,
        seed=seed,
        verbose=True,
    )
    p0 = np.array([0.3, 0.0, 0.7])
    p1 = np.array([0.45, -0.5, 0.2])
    r0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    r1 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()

    start = time.time()
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)
    print(f"Path planning took {time.time() - start:.2f}s")
    print("Via points:")
    for p in p_via:
        print("  ", np.round(p, 4))

    if plot:
        from boundplanner_tpu.viz import plot_via_path
        import matplotlib.pyplot as plt

        plot_via_path(p_via, r_via, sets_via, planner.obs_sets)
        plt.show()
    return p_via, r_via, bp1_list, sets_via


if __name__ == "__main__":
    main(plot="--plot" in sys.argv)
