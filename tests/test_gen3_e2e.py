"""Gen3 end-to-end: the whole planner -> MPC stack on the Kinova Gen3.

The reference switches its ENTIRE pipeline to the Gen3 with one flag
(USE_IIWA, `bound_planner/RobotModel/RobotModel.py:10,18-21`): URDF,
limits, and the symbolic FK the OCP consumes all follow. Here the same
switch is ``MPCParams(robot="gen3")`` — these tests pin that the knob
actually reaches the OCP/MPC (the chain once existed
but the pipeline was hard-wired to the iiwa default).
"""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation as R

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.mpc import MPCNode
from boundplanner_tpu.planner import BoundPlanner

GEN3_CFG = MPCParams(robot="gen3")
Q0 = np.array([0.0, 0.5, 0.0, 1.2, 0.0, -0.8, 0.0])


def test_gen3_reaches_ocp():
    """The robot knob must change the OCP evaluation (not just the host
    facade): same decision vector, different FK -> different residuals."""
    import jax.numpy as jnp

    from boundplanner_tpu.mpc.bound_mpc import build_tick_params
    from boundplanner_tpu.mpc import ocp
    from boundplanner_tpu.mpc.node import MPCNode as _Node

    node = _Node(Q0, params=GEN3_CFG)
    meas = {
        "q0": jnp.asarray(Q0),
        "dq0": jnp.zeros(7),
        "ddq0": jnp.zeros(7),
        "p0": jnp.asarray(node.p0),
        "v0": jnp.zeros(6),
        "u0": jnp.zeros(7),
        "qf": jnp.asarray(Q0),
    }
    import functools
    import jax

    params, _, _, _ = jax.jit(build_tick_params, static_argnames=("cfg",))(
        node.mpc.carry, meas, node.mpc.obs, GEN3_CFG
    )
    params = jax.tree.map(jnp.asarray, params)
    x = 0.01 * jnp.ones(ocp.n_vars(GEN3_CFG.n))
    ev = jax.jit(ocp.evaluate, static_argnames=("cfg",))
    r_g, g_g = ev(x, params, cfg=GEN3_CFG)
    cfg_iiwa = MPCParams()
    r_i, g_i = ev(x, params, cfg=cfg_iiwa)
    assert not np.allclose(np.asarray(r_g), np.asarray(r_i)), (
        "gen3 FK did not reach the OCP residuals"
    )
    # gen3 dq limit rows (1.39 rad/s vs iiwa 10) must differ too
    assert not np.allclose(np.asarray(g_g), np.asarray(g_i))
    assert np.isfinite(np.asarray(g_g)).all(), "inf leaked from the clamped limits"


@pytest.mark.slow
def test_gen3_plan_and_track():
    """A gen3 scene tracks closed-loop on CPU."""
    node = MPCNode(Q0, params=GEN3_CFG)

    p0fk, _, _ = node.robot_model.forward_kinematics(Q0, 0 * Q0)
    p0 = p0fk[:3]
    r0 = R.from_rotvec(np.array(p0fk[3:])).as_matrix()
    p1 = np.array([0.35, 0.35, 0.55])
    r1 = r0.copy()  # translation-dominant task; keep orientation

    obstacles = [[-1.0, -1.0, -0.2, 1.0, 1.0, 0.05]]  # floor slab
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=[1.0, 1.0, 1.2],
        workspace_min=[-1.0, -1.0, 0.05],
        seed=0,
    )
    p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(p0, p1, r0, r1)
    assert len(p_via) >= 2

    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1_list = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    e_r_bound = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180] * len(bp1_list)
    node.update_reference(
        p_via, r_via, bp1_list, br1_list, e_r_bound, a_sets, b_sets, obstacles
    )

    phis = []
    ticks = 0
    # gen3 joints are ~7x slower than the iiwa (dq_lim 1.39 vs 10 rad/s),
    # so allow a longer tick budget for the same path length
    while (
        float(node.mpc.phi_current[0]) < float(node.mpc.phi_max[0]) - 0.001
        and ticks < 90
    ):
        node.step()
        phis.append(float(node.mpc.phi_current[0]))
        ticks += 1

    assert phis[-1] > float(node.mpc.phi_max[0]) - 0.02, (
        f"did not reach path end: phi {phis[-1]:.3f} / {float(node.mpc.phi_max[0]):.3f}"
        f" in {ticks} ticks"
    )
    goal_err = np.linalg.norm(node.p_lie[:3] - p1)
    assert goal_err < 0.02, f"final EE error {goal_err * 1000:.1f} mm"
    assert sum(node.fails) <= 2
