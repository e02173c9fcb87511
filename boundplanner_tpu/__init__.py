"""boundplanner_tpu — a batched JAX planning + MPC engine.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the
Thieso/BoundPlanner reference (convex-set path planning + error-bounded
model-predictive trajectory tracking for a 7-DoF arm), built for batched
execution on GPUs:

- ``robot``    : pure-JAX iiwa14 kinematics (FK, world-aligned Jacobians,
                 Jacobian time-derivatives via ``jvp``), replacing
                 Pinocchio / serialized-CasADi graphs.
- ``ops``      : batched dense convex solvers (interior-point QP/LP, MVIE
                 barrier-Newton ellipsoid solver) that replace qpOASES /
                 OSQP / CLARABEL / HiGHS, all ``vmap``-able.
- ``path``     : arc-length-parameterized piecewise-linear pose reference
                 with fixed-shape moving segment window.
- ``planner``  : convex-set graph planner (host graph orchestration over
                 batched device geometry kernels).
- ``mpc``      : the BoundMPC optimal control problem condensed onto the
                 jerk sequence and solved with a batched SQP.
- ``parallel`` : scenario batching, device meshes and collectives.
"""

from .config import MPCParams, default_mpc_params

__all__ = ["MPCParams", "default_mpc_params"]
__version__ = "0.1.0"
