"""Tiny self-contained demo scene builders used by ``__graft_entry__`` and
``bench.py``.

Everything here is pure numpy: scene construction is transfer-only (no
eager device ops; numpy pytrees cross the jit boundary in one transfer).
"""

from __future__ import annotations

import numpy as np

import jax

from .config import MPCParams
from .mpc.bound_mpc import init_carry_np
from .path.reference_path import build_path_np
from .planner.set_finder import build_obstacle_arrays_np

DEMO_Q0 = np.array([0.0, 0.0, 0.0, -np.pi / 2, 0.0, np.pi / 2, 0.0])


def _fk_pose_np(q):
    """Numpy FK for scene setup (the device path is `robot.kinematics`)."""
    from scipy.spatial.transform import Rotation as R

    from .robot.kinematics import _EE_R, _EE_XYZ, _JOINT_R, _JOINT_XYZ

    r = np.eye(3)
    p = np.zeros(3)
    for i in range(7):
        p = p + r @ _JOINT_XYZ[i]
        c, s = np.cos(q[i]), np.sin(q[i])
        rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
        r = r @ _JOINT_R[i] @ rz
    r_ee = r @ _EE_R
    p_ee = p + r @ _EE_XYZ
    return np.concatenate([p_ee, R.from_matrix(r_ee).as_rotvec()])


def demo_scene(cfg: MPCParams, dtype=np.float32, goal_offset=(0.0, -0.3, 0.0)):
    """A single tracking scene (numpy pytrees): straight-line path from the
    FK pose of the demo configuration, one box obstacle off to the side."""
    from scipy.spatial.transform import Rotation as R

    q0 = DEMO_Q0.copy()
    pose0 = _fk_pose_np(q0)
    p0 = pose0[:3]
    r0 = R.from_rotvec(pose0[3:]).as_matrix()

    p_via = [p0.copy(), p0 + np.asarray(goal_offset)]
    r_via = [r0, r0]
    bp1 = [np.array([0.0, 0.0, 1.0])]
    br1 = [np.array([0.0, 0.0, 1.0])]
    e_r_bound = [np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180]
    a_sets = [np.zeros((15, 3))]
    b_sets = [np.ones(15)]

    path = build_path_np(
        p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets, nr_segs=cfg.nr_segs,
        dtype=dtype,
    )
    carry = init_carry_np(path, pose0, cfg, dtype)
    obs = build_obstacle_arrays_np([[0.7, -0.2, 0.0, 0.9, 0.0, 0.4]], dtype=dtype)

    meas = {
        "q0": np.asarray(q0, dtype),
        "dq0": np.zeros(7, dtype),
        "ddq0": np.zeros(7, dtype),
        "p0": np.asarray(pose0, dtype),
        "v0": np.zeros(6, dtype),
        "u0": np.zeros(7, dtype),
        "qf": np.asarray(q0, dtype),
    }
    return carry, meas, obs, np.asarray(q0)


def demo_fleet(cfg: MPCParams, batch: int, dtype=np.float32):
    """A deterministic fleet of ``batch`` DISTINCT tracking scenes (each
    with its own goal offset), stacked into batched numpy pytrees.

    Used by the multi-process tests: distinct per-scene trajectories make
    shard-feeding bugs (wrong slice, wrong order) observable.
    Returns (carry_b, obs_b, q0_b)."""
    carries, obses, q0s = [], [], []
    for i in range(batch):
        off = (0.05 * np.sin(2.1 * i), -0.2 - 0.15 * (i % 5) / 4.0, 0.04 * np.cos(1.3 * i))
        carry, _, obs, q0 = demo_scene(cfg, dtype, goal_offset=off)
        carries.append(carry)
        obses.append(obs)
        q0s.append(q0)
    stack = lambda *xs: np.stack(xs)
    return (
        jax.tree.map(stack, *carries),
        jax.tree.map(stack, *obses),
        np.stack(q0s),
    )


def stack_scenes(carry, meas, obs, batch: int):
    """Replicate a single (numpy) scene into a batch (leading axis)."""
    tile = lambda x: np.broadcast_to(np.asarray(x), (batch,) + np.shape(x)).copy()
    return (
        jax.tree.map(tile, carry),
        jax.tree.map(tile, meas),
        jax.tree.map(tile, obs),
    )
