"""Pure-JAX kinematics of the KUKA iiwa14.

Pure-JAX replacement for the reference's Pinocchio / serialized-CasADi
kinematics (`bound_planner/RobotModel/RobotModel.py:146-267` and the
``*.ca`` blobs). The kinematic chain is transcribed from
`bound_planner/RobotModel/iiwa.urdf`:

- 7 revolute joints, each about its local z axis (`iiwa.urdf:26,41,56,71,86,107,122`)
- fixed joint origins (xyz / rpy, URDF convention R = Rz(y)Ry(p)Rx(r)):
    joint_1: xyz (0,0,0.1525)   rpy (0,0,0)            `iiwa.urdf:25`
    joint_2: xyz (0,0,0.2075)   rpy (pi/2,0,pi)        `iiwa.urdf:40`
    joint_3: xyz (0,0.2325,0)   rpy (pi/2,0,pi)        `iiwa.urdf:55`
    joint_4: xyz (0,0,0.1875)   rpy (pi/2,0,0)         `iiwa.urdf:70`
    joint_5: xyz (0,0.2125,0)   rpy (-pi/2,pi,0)       `iiwa.urdf:85`
    joint_6: xyz (0,0,0.1875)   rpy (pi/2,0,0)         `iiwa.urdf:107`
    joint_7: xyz (0,0.0796,0)   rpy (-pi/2,pi,0)       `iiwa.urdf:122`
- end-effector frame: from link_7, xyz (0,0,0.21), rpy (0,-1.575,-1.575)
  (`iiwa.urdf:137`)
- collision frames (ref `RobotModel.py:27-35`): origins of joints 3..7,
  link4_col (link_4 + xyz (0,0.3,0), `iiwa.urdf:91`), end_effector_col
  (link_7 + xyz (0,0,0.13), `iiwa.urdf:143`).

The frame Jacobian follows Pinocchio's LOCAL_WORLD_ALIGNED convention
(world-aligned axes at the end-effector point): column i is
``[z_i x (p_ee - p_i); z_i]``. Its time derivative is obtained by a
``jvp`` of the Jacobian map — exact, no finite differences.

All functions are shape-static, differentiable and ``vmap``-able.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.so3 import matrix_to_rotvec

NUM_JOINTS = 7

_PI = np.pi
_HPI = np.pi / 2.0

# (xyz, rpy) of each joint's fixed placement relative to the previous frame.
_JOINT_XYZ = np.array(
    [
        [0.0, 0.0, 0.1525],
        [0.0, 0.0, 0.2075],
        [0.0, 0.2325, 0.0],
        [0.0, 0.0, 0.1875],
        [0.0, 0.2125, 0.0],
        [0.0, 0.0, 0.1875],
        [0.0, 0.0796, 0.0],
    ]
)
_JOINT_RPY = np.array(
    [
        [0.0, 0.0, 0.0],
        [_HPI, 0.0, _PI],
        [_HPI, 0.0, _PI],
        [_HPI, 0.0, 0.0],
        [-_HPI, _PI, 0.0],
        [_HPI, 0.0, 0.0],
        [-_HPI, _PI, 0.0],
    ]
)
_EE_XYZ = np.array([0.0, 0.0, 0.21])
_EE_RPY = np.array([0.0, -1.575, -1.575])
_LINK4_COL_XYZ = np.array([0.0, 0.3, 0.0])
_EE_COL_XYZ = np.array([0.0, 0.0, 0.13])


def _rpy_to_matrix(rpy: np.ndarray) -> np.ndarray:
    """URDF rpy convention: R = Rz(yaw) @ Ry(pitch) @ Rx(roll)."""
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


# Static fixed transforms, computed once at import in float64.
_JOINT_R = np.stack([_rpy_to_matrix(r) for r in _JOINT_RPY])  # (7, 3, 3)
_EE_R = _rpy_to_matrix(_EE_RPY)


class RobotChain:
    """Static chain description (numpy constants baked at trace time).

    Default is the iiwa14; ``gen3_chain()`` builds the Kinova Gen3 from
    `bound_planner/RobotModel/gen3_arm.urdf:27-137` (same structure: 7
    revolute z joints, fixed EE / collision frames)."""

    def __init__(self, joint_xyz, joint_rpy, ee_xyz, ee_rpy,
                 link4_col_xyz, ee_col_xyz, name="iiwa14"):
        self.name = name
        self.joint_xyz = np.asarray(joint_xyz, dtype=np.float64)
        self.joint_r = np.stack([_rpy_to_matrix(np.asarray(r)) for r in joint_rpy])
        self.ee_xyz = np.asarray(ee_xyz, dtype=np.float64)
        self.ee_r = _rpy_to_matrix(np.asarray(ee_rpy, dtype=np.float64))
        self.link4_col_xyz = np.asarray(link4_col_xyz, dtype=np.float64)
        self.ee_col_xyz = np.asarray(ee_col_xyz, dtype=np.float64)


IIWA14_CHAIN = RobotChain(
    _JOINT_XYZ, _JOINT_RPY, _EE_XYZ, _EE_RPY, _LINK4_COL_XYZ, _EE_COL_XYZ,
    name="iiwa14",
)


@functools.lru_cache(maxsize=None)
def gen3_chain() -> RobotChain:
    """Kinova Gen3 chain (`gen3_arm.urdf:27-137`; selected in the reference
    via USE_IIWA=False, `RobotModel.py:10,18-21`). Cached: one shared
    instance, so every trace bakes the same numpy constants."""
    return RobotChain(
        joint_xyz=[
            [0.0, 0.0, 0.15643],
            [0.0, 0.005375, -0.12838],
            [0.0, -0.21038, -0.006375],
            [0.0, 0.006375, -0.21038],
            [0.0, -0.20843, -0.006375],
            [0.0, 0.00017505, -0.10593],
            [0.0, -0.10593, -0.00017505],
        ],
        joint_rpy=[
            [np.pi, 0.0, 0.0],
            [np.pi / 2, 0.0, 0.0],
            [-np.pi / 2, 0.0, 0.0],
            [np.pi / 2, 0.0, 0.0],
            [-np.pi / 2, 0.0, 0.0],
            [np.pi / 2, 0.0, 0.0],
            [-np.pi / 2, 0.0, 0.0],
        ],
        ee_xyz=[0.0, 0.0, -0.20],
        ee_rpy=[0.0, 1.570796326794895, 1.570796326794895],
        link4_col_xyz=[0.0, -0.1, 0.0],
        ee_col_xyz=[0.0, 0.0, -0.13],
        name="gen3",
    )


def chain_by_name(name: str | None):
    """Resolve a config robot name to a chain constant (None = the iiwa14
    static default — every kinematics function's fast path)."""
    if name in (None, "iiwa14"):
        return None
    if name == "gen3":
        return gen3_chain()
    raise ValueError(f"unknown robot {name!r} (expected 'iiwa14' or 'gen3')")


def _rotz(q):
    c, s = jnp.cos(q), jnp.sin(q)
    one = jnp.ones_like(c)
    zero = jnp.zeros_like(c)
    return jnp.stack(
        [
            jnp.stack([c, -s, zero]),
            jnp.stack([s, c, zero]),
            jnp.stack([zero, zero, one]),
        ]
    )


def _lincomb(cols, coefs, tol=1e-12):
    """sum_k coefs[k] * cols[k] with STATIC numpy coefficients.

    Skips |coef| < tol crumbs (the cos(pi/2) ~ 6e-17 entries of the
    fixed joint rotations) and folds exact +-1 into adds/negations, so
    a constant signed-permutation factor costs zero multiplies."""
    out = None
    for k in range(len(cols)):
        c = float(coefs[k])
        if abs(c) < tol:
            continue
        if c == 1.0:
            term = cols[k]
        elif c == -1.0:
            term = -cols[k]
        else:
            term = c * cols[k]
        out = term if out is None else out + term
    if out is None:
        out = jnp.zeros_like(cols[0])
    return out


def fk_frames(q, chain: "RobotChain" = None):
    """World placements of all 7 joint frames + EE + collision frames.

    Returns a dict with:
      ``r``  (7,3,3)  rotation of each joint frame (after the joint motion)
      ``p``  (7,3)    origin of each joint frame (= Pinocchio ``oMi`` translation)
      ``r_ee`` (3,3), ``p_ee`` (3,)  end_effector_link frame
      ``p_col`` (7,3) collision points: joints 3..7, link4_col, ee_col
        (ordering of ref `RobotModel.py:27-35`)

    ``chain`` selects the robot (default iiwa14; see ``gen3_chain``).

    Re-design note: the chain is evaluated as COLUMN operations, not
    3x3 matmuls. Each fixed joint rotation is a signed permutation (rpy
    multiples of pi/2, `iiwa.urdf:25-122`), so ``r_cur @ joint_r[i]`` is a
    static column shuffle, and right-multiplying by Rz(q_i) mixes only
    columns 0/1: col0' = c*A0 + s*A1, col1' = c*A1 - s*A0, col2' = A2.
    Under the fleet vmap the per-joint 3x3 matmuls would each be a tiny
    matmul; the column form is fusable (batch, 3) element-wise FMA chains.
    Values identical up to dropping ~6e-17 crumb entries of the constant
    factors and float reassociation (ulps)."""
    if chain is None:
        chain = IIWA14_CHAIN
    dtype = jnp.asarray(q).dtype
    joint_r_np = np.asarray(chain.joint_r)      # static float64 constants
    joint_xyz_np = np.asarray(chain.joint_xyz)

    rs = []
    ps = []
    eye = np.eye(3)
    cols = [jnp.asarray(eye[:, k], dtype=dtype) for k in range(3)]
    p_cur = jnp.zeros(3, dtype=dtype)
    for i in range(NUM_JOINTS):
        p_cur = p_cur + _lincomb(cols, joint_xyz_np[i])
        a = [_lincomb(cols, joint_r_np[i][:, j]) for j in range(3)]
        c, s = jnp.cos(q[i]), jnp.sin(q[i])
        cols = [c * a[0] + s * a[1], c * a[1] - s * a[0], a[2]]
        rs.append(jnp.stack(cols, axis=-1))
        ps.append(p_cur)
    r = jnp.stack(rs)
    p = jnp.stack(ps)
    cols6 = cols

    ee_r_np = np.asarray(chain.ee_r)
    r_ee = jnp.stack(
        [_lincomb(cols6, ee_r_np[:, j]) for j in range(3)], axis=-1
    )
    p_ee = p[6] + _lincomb(cols6, np.asarray(chain.ee_xyz))

    cols3 = [r[3][:, k] for k in range(3)]
    p_link4_col = p[3] + _lincomb(cols3, np.asarray(chain.link4_col_xyz))
    p_ee_col = p[6] + _lincomb(cols6, np.asarray(chain.ee_col_xyz))
    p_col = jnp.concatenate(
        [p[2:7], p_link4_col[None], p_ee_col[None]], axis=0
    )  # (7, 3)

    return {"r": r, "p": p, "r_ee": r_ee, "p_ee": p_ee, "p_col": p_col}


def fk_ee_htm(q, chain=None):
    """4x4 homogeneous transform of the end effector
    (ref `RobotModel.py:197-211` hom_transform_endeffector)."""
    f = fk_frames(q, chain)
    h = jnp.eye(4, dtype=f["r_ee"].dtype)
    h = h.at[:3, :3].set(f["r_ee"])
    h = h.at[:3, 3].set(f["p_ee"])
    return h


def fk_pos(q, chain=None):
    """End-effector position (ref `RobotModel.py:146-160`)."""
    return fk_frames(q, chain)["p_ee"]


def fk_pose(q, chain=None):
    """6-vector [position; rotation-vector] of the EE (ref `RobotModel.py:183-195`)."""
    f = fk_frames(q, chain)
    return jnp.concatenate([f["p_ee"], matrix_to_rotvec(f["r_ee"])])


def fk_pos_col_all(q, chain=None):
    """All 7 collision-frame positions, (7,3) (ref `RobotModel.py:162-181`)."""
    return fk_frames(q, chain)["p_col"]


def fk_pos_col(q, i: int):
    """Collision-frame position i (static index)."""
    return fk_frames(q)["p_col"][i]


def jacobian_fk(q, chain=None):
    """6x7 frame Jacobian of the EE in LOCAL_WORLD_ALIGNED convention
    (ref `RobotModel.py:213-231`): rows [linear; angular], column i =
    [z_i x (p_ee - p_i); z_i] with world-frame joint axes z_i."""
    f = fk_frames(q, chain)
    z = f["r"][:, :, 2]  # (7, 3) world joint axes
    dp = f["p_ee"][None, :] - f["p"]  # (7, 3)
    jv = jnp.cross(z, dp)  # (7, 3)
    return jnp.concatenate([jv.T, z.T], axis=0)  # (6, 7)


def jacobian_col(q, i: int):
    """3x7 positional Jacobian of collision frame i (via autodiff)."""
    return jax.jacfwd(lambda qq: fk_pos_col(qq, i))(q)


def djacobian_fk(q, dq):
    """Time derivative of the LOCAL_WORLD_ALIGNED Jacobian, dJ/dt = (dJ/dq) dq,
    computed exactly with a jvp (ref `RobotModel.py:233-251`
    getFrameJacobianTimeVariation)."""
    return jax.jvp(jacobian_fk, (q,), (dq,))[1]


def velocity_ee(q, dq):
    """Cartesian EE velocity (ref `RobotModel.py:253-256`)."""
    return (jacobian_fk(q) @ dq)[:3]


def omega_ee(q, dq):
    """EE angular velocity (ref `RobotModel.py:264-267`)."""
    return (jacobian_fk(q) @ dq)[3:]


def forward_kinematics(q, dq):
    """(pose6, J, dJ) — ref `RobotModel.py:70-77`."""
    return fk_pose(q), jacobian_fk(q), djacobian_fk(q, dq)
