"""Robot model facade: limits, collision geometry, IK.

Replaces the reference ``RobotModel`` class
(`bound_planner/RobotModel/RobotModel.py:15-267`). Joint limits are
transcribed from `bound_planner/RobotModel/iiwa.urdf:27,42,57,72,87,109,124`
and `RobotModel.py:49-54`; collision sphere radii from `RobotModel.py:37`.

Inverse kinematics re-designs the reference's Ipopt NLP
(`RobotModel.py:79-130`) as a bounded damped Gauss-Newton iteration in
pure JAX (jit/vmap-able), minimizing the same objective
``|fk_pos(q) - pd|^2 + |R(q) Rd^T - I|_F^2``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import kinematics as kin
from .kinematics import gen3_chain  # noqa: F401  (re-export)

Q_LIM_UPPER = np.array(
    [
        2.9670597283903604,
        2.0943951023931953,
        2.9670597283903604,
        2.0943951023931953,
        2.9670597283903604,
        2.0943951023931953,
        3.0543261909900763,
    ]
)
Q_LIM_LOWER = -Q_LIM_UPPER
DQ_LIM = 10.0 * np.ones(7)
TAU_LIM_UPPER = np.array([320.0, 320.0, 176.0, 176.0, 110.0, 40.0, 40.0])
TAU_LIM_LOWER = -TAU_LIM_UPPER
U_MAX = 35.0
U_MIN = -35.0
DDQ_LIM = 5.0  # acceleration bound used by the OCP (ref `BoundMPC.py:182`)

COL_JOINT_SIZES = np.array([0.09, 0.12, 0.09, 0.10, 0.07, 0.09, 0.075])

# Kinova Gen3 limits (`gen3_arm.urdf:32,46,60,74,88,109,123`; continuous
# joints 1/3/5/7 get +-inf like the reference, `RobotModel.py:46-48`)
GEN3_Q_LIM_UPPER = np.array([np.inf, 2.24, np.inf, 2.57, np.inf, 2.09, np.inf])
GEN3_DQ_LIM = np.array([1.3963, 1.3963, 1.3963, 1.3963, 1.2218, 1.2218, 1.2218])
GEN3_COL_JOINT_SIZES = np.array([0.09, 0.09, 0.06, 0.06, 0.06, 0.06, 0.075])

# Finite stand-in for the gen3 continuous joints' +-inf position limits
# inside the OCP's inequality rows. Deviation from the reference: Ipopt
# accepts +-inf variable bounds natively (`RobotModel.py:46-48`), but the
# IPM keeps a finite slack s = -g for EVERY row — an inf bound would put
# inf/nan into the f32 iterate. 1e3 rad is > 150 full revolutions, i.e.
# unreachable within any horizon: the rows are permanently inactive, like
# the reference's inf bounds.
OCP_INF_CLAMP = 1e3


@functools.lru_cache(maxsize=None)
def ocp_limits(robot: str = "iiwa14"):
    """(q_ub, q_lb, dq_lim, col_sizes) numpy constants for the OCP's
    bound rows and link-collision sets, per robot (the limit surface the
    reference reads off `RobotModel.get_robot_limits`, `RobotModel.py:44-68`).
    DDQ_LIM / U_MAX are robot-independent (`BoundMPC.py:182`,
    `RobotModel.py:53-54`)."""
    if robot == "gen3":
        q_ub = np.where(np.isinf(GEN3_Q_LIM_UPPER), OCP_INF_CLAMP, GEN3_Q_LIM_UPPER)
        return q_ub, -q_ub, GEN3_DQ_LIM.copy(), GEN3_COL_JOINT_SIZES.copy()
    if robot in (None, "iiwa14"):
        return Q_LIM_UPPER.copy(), Q_LIM_LOWER.copy(), DQ_LIM.copy(), COL_JOINT_SIZES.copy()
    raise ValueError(f"unknown robot {robot!r}")


def _ik_gauss_newton(pd, rd, q0, chain=None, q_lim=None, iters: int = 60):
    """Bounded damped Gauss-Newton IK on the reference objective."""
    q_ub = Q_LIM_UPPER if q_lim is None else q_lim
    lo = jnp.asarray(-q_ub, dtype=q0.dtype)
    hi = jnp.asarray(q_ub, dtype=q0.dtype)

    def residuals(q):
        f = kin.fk_frames(q, chain)
        r_pos = f["p_ee"] - pd
        r_rot = (f["r_ee"] @ rd.T - jnp.eye(3, dtype=q.dtype)).reshape(-1)
        return jnp.concatenate([r_pos, r_rot])

    def body(carry, _):
        q, lam = carry
        r = residuals(q)
        jac = jax.jacfwd(residuals)(q)
        h = jac.T @ jac + lam * jnp.eye(7, dtype=q.dtype)
        step = jnp.linalg.solve(h, jac.T @ r)
        q_new = jnp.clip(q - step, lo, hi)
        improved = jnp.sum(residuals(q_new) ** 2) < jnp.sum(r**2)
        q = jnp.where(improved, q_new, q)
        lam = jnp.where(improved, jnp.maximum(lam * 0.5, 1e-8), lam * 4.0)
        return (q, lam), None

    (q, _), _ = jax.lax.scan(body, (q0, jnp.asarray(1e-4, q0.dtype)), None, length=iters)
    return q


class RobotModel:
    """Host-side facade over the pure-JAX kinematics functions.

    ``robot="iiwa14"`` (default) or ``"gen3"`` — the reference's USE_IIWA
    switch (`RobotModel.py:10,18-21,36-39,46-48`)."""

    def __init__(self, robot: str = "iiwa14"):
        self.robot = robot
        if robot == "gen3":
            self.chain = kin.gen3_chain()
            self.q_lim_upper = GEN3_Q_LIM_UPPER.copy()
            self.q_lim_lower = -GEN3_Q_LIM_UPPER.copy()
            self.dq_lim_upper = GEN3_DQ_LIM.copy()
            self.dq_lim_lower = -GEN3_DQ_LIM.copy()
            self.col_joint_sizes = GEN3_COL_JOINT_SIZES.copy()
        else:
            self.chain = None  # iiwa14 static default
            self.q_lim_upper = Q_LIM_UPPER.copy()
            self.q_lim_lower = Q_LIM_LOWER.copy()
            self.dq_lim_upper = DQ_LIM.copy()
            self.dq_lim_lower = -DQ_LIM.copy()
            self.col_joint_sizes = COL_JOINT_SIZES.copy()
        self.tau_lim_upper = TAU_LIM_UPPER.copy()
        self.tau_lim_lower = TAU_LIM_LOWER.copy()
        self.u_max = U_MAX
        self.u_min = U_MIN

    def get_robot_limits(self):
        return (
            self.q_lim_upper,
            self.q_lim_lower,
            self.dq_lim_upper,
            self.dq_lim_lower,
            self.tau_lim_upper,
            self.tau_lim_lower,
            self.u_max,
            self.u_min,
        )

    # --- kinematics pass-throughs (numpy in / numpy out) ---
    # jitted once per chain: host-side calls dispatch a single compiled
    # program instead of an eager op chain

    def _fk_bundle(self):
        if not hasattr(self, "_fk_jit"):
            chain = self.chain

            def bundle(q, dq):
                p = kin.fk_pose(q, chain)
                jac = kin.jacobian_fk(q, chain)
                djac = jax.jvp(lambda qq: kin.jacobian_fk(qq, chain), (q,), (dq,))[1]
                return p, jac, djac

            self._fk_jit = jax.jit(bundle)
        return self._fk_jit

    def forward_kinematics(self, q, dq):
        p, jac, djac = self._fk_bundle()(jnp.asarray(q), jnp.asarray(dq))
        return np.asarray(p), np.asarray(jac), np.asarray(djac)

    def fk(self, q):
        return np.asarray(kin.fk_pose(jnp.asarray(q), self.chain))

    def fk_pos(self, q):
        return np.asarray(kin.fk_pos(jnp.asarray(q), self.chain))

    def fk_pos_col(self, q, i):
        return np.asarray(kin.fk_pos_col_all(jnp.asarray(q), self.chain))[i]

    def hom_transform_endeffector(self, q):
        return np.asarray(kin.fk_ee_htm(jnp.asarray(q), self.chain))

    def jacobian_fk(self, q):
        return np.asarray(kin.jacobian_fk(jnp.asarray(q), self.chain))

    def djacobian_fk(self, q, dq):
        return np.asarray(kin.djacobian_fk(jnp.asarray(q), jnp.asarray(dq)))

    def velocity_ee(self, q, dq):
        return np.asarray(kin.velocity_ee(jnp.asarray(q), jnp.asarray(dq)))

    def omega_ee(self, q, dq):
        return np.asarray(kin.omega_ee(jnp.asarray(q), jnp.asarray(dq)))

    def inverse_kinematics(self, pd, rd, q0):
        """Optimization-based IK (ref `RobotModel.py:132-144`)."""
        if not hasattr(self, "_ik_jit"):
            chain, q_ub = self.chain, self.q_lim_upper

            self._ik_jit = jax.jit(
                lambda pd_, rd_, q0_: _ik_gauss_newton(pd_, rd_, q0_, chain, q_ub)
            )
        q = self._ik_jit(
            jnp.asarray(pd, dtype=jnp.float64 if jax.config.jax_enable_x64 else jnp.float32),
            jnp.asarray(rd),
            jnp.asarray(q0),
        )
        return np.asarray(q)
