"""Configuration for the JAX BoundPlanner/BoundMPC engine.

Mirrors the knob surface of the reference (`bound_planner/utils/util_functions.py:11-50`
``Params`` namedtuple and the module-level set-size literals) as frozen
dataclasses usable as static jit arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

# Fixed problem dimensions (reference: N=15, nr_segs=4, 7 joints,
# 15-row MPC sets / 20-row planner sets;
# `casadi_ocp_formulation.py:29`, `BoundPlanner.py:51`).
NUM_JOINTS = 7
MPC_SET_ROWS = 15
PLANNER_SET_ROWS = 20
NUM_LINK_SETS = 6  # collision frames constrained inside the OCP


@dataclasses.dataclass(frozen=True)
class MPCParams:
    """Static MPC configuration (hashable → usable as a jit static arg)."""

    n: int = 15                # horizon length N
    dt: float = 0.1            # sampling time [s]
    nr_segs: int = 4           # path segments visible to the OCP window
    # robot selection — the reference's USE_IIWA flag
    # (`RobotModel/RobotModel.py:10,18-21`) switches URDF, limits and the
    # symbolic FK consumed by the whole OCP stack; here the static config
    # knob selects the kinematic chain + limits at trace time
    # ("iiwa14" or "gen3").
    robot: str = "iiwa14"
    max_set_size: int = MPC_SET_ROWS
    # Objective weights, same layout as the reference weight vector
    # (w_p, w_r, w_v_p, w_v_r, w_phi, w_dphi, w_dq, w_jerk, w_term,
    #  w_slack, w_dslack) — `util_functions.py:34-48`.
    weights: Tuple[float, ...] = ()
    # SQP solver knobs (new design — replaces the Ipopt option block,
    # `BoundMPC.py:202-224`).
    sqp_iters: int = 12
    qp_iters: int = 25
    line_search_steps: int = 6
    merit_penalty: float = 1e3
    # QP subproblem backend: "ipm" (Mehrotra, one factorization per IPM
    # iteration) or "admm" (OSQP-style, ONE factorization per SQP
    # iteration + admm_iters cheap matvec sweeps)
    qp_solver: str = "ipm"
    admm_iters: int = 60
    # structured chain-rule OCP Jacobians (`mpc.ocp_jac`) instead of
    # jacfwd through the full evaluation — identical values, fewer tangents
    manual_jac: bool = False
    # exploit the block-banded OCP structure end to end (`mpc.ocp_struct`):
    # 12-tangent (p,v) local AD, static bound/slack rows applied
    # structurally inside the IPM (out of the streamed constraint matrix
    # and the dense Gram), causal chunk-split Gram products. Implies the
    # manual-jac chain rule; ~2.3x fewer FLOPs per solve.
    struct_ocp: bool = False
    # sub-knobs of struct_ocp (each A/B-gated on wall clock — fewer FLOPs
    # is not automatically faster on a latency-bound tick):
    # struct_tail=False materializes the static rows back into a dense
    # constraint matrix (isolates the 12-tangent AD win); struct_chunked=
    # False keeps the structural tail but skips the causal chunk split of
    # the runtime Gram (single full-width product, no gathers/scatters).
    struct_tail: bool = True
    struct_chunked: bool = True
    # apply the 1260 link-collision rows (80% of the runtime constraint
    # matrix) through their exact factorization J = A_l @ acol_u - e_dsl
    # instead of materializing/streaming them densely (`ocp_struct.link_*`).
    # Not adopted: slower than the dense row block in earlier measurements;
    # kept with full f64 equivalence tests.
    struct_link: bool = False
    # carry the QP's inequality duals across SQP iterations as the next
    # subproblem's interior-point warm start (clipped into a safe cone).
    # MEASURED NEGATIVE: no speedup at equal iters and max viol blows up
    # (0.008 -> 3.3 on the random fleet) — a warm z against cold slacks
    # s = max(h, 1) starts the iterate far off the central path, which
    # hurts more than the inherited active set helps. Needs a paired
    # (s, z) least-squares init to revisit.
    qp_warm_dual: bool = False
    # PAIRED Mehrotra (s, z) warm start (the revisit the qp_warm_dual
    # negative asked for): initialize s from the ACTUAL warm-start slack
    # h - G x0 and z from the carried duals, then apply Mehrotra's
    # initial-point centering shifts. Requires qp_warm_dual=True to carry
    # z across SQP iterations. Not adopted.
    qp_warm_sz: bool = False
    # compute the IPM dual residual's G^T z stream in bfloat16 (bounded
    # per-iteration rounding of the Newton rhs; NOT the round-1-negative
    # recursive carry, whose error accumulates)
    qp_bf16_rd: bool = False
    # Gondzio multiple-centrality correctors per IPM iteration (extra
    # cheap solves against the existing factorization; buys larger steps
    # so fewer IPM iterations carry the same accuracy)
    qp_gondzio: int = 0
    # shift the warm start one control period (the reference re-uses the
    # unshifted previous solution, `BoundMPC.py:412-428`)
    warm_shift: bool = False
    # stream the QP constraint matrix in bfloat16 for search-direction
    # products (f32 accumulation + refinement absorb the error)
    qp_bf16: bool = False
    # refresh the IPM KKT factorization only every k-th iteration; frozen
    # iterations reuse the stale factor with extra implicit-operator
    # refinement. EXPERIMENTAL, NEGATIVE RESULT at OCP scale: the stale
    # preconditioner does not contract when w = z/s moves fast (CPU
    # obstacle gate: 8 infeasibility fallbacks vs 0, 44 ticks vs 38 at
    # kkt_every=2) — keep 1 unless re-gated
    kkt_every: int = 1
    # ---- budget escalation on failing ticks (round 4) ----
    # The perf iteration budget leaves ~1% of fleet ticks infeasible
    # (viol ~1e-3); the hard-scene anchor proved those ticks are
    # iteration-budget misses that the SAME solver closes at
    # sqp_iters=6 / qp_iters=8 (tests/test_external_anchor.py, matching
    # SLSQP's optimum; the reference's Ipopt budget max_iter=100 solves
    # them as a matter of course, `BoundMPC.py:203-206`). esc_lanes > 0
    # enables a batch-level retry inside the fleet rollout
    # (`parallel.batch.fleet_rollout`): failing lanes (up to esc_lanes
    # per tick) are compacted into a fixed-width sub-batch and re-ticked
    # at the escalated budget under a REAL `lax.cond` — ticks where the
    # whole batch succeeded pay nothing, and fired ticks pay only the
    # sub-batch (esc_lanes/batch of an escalated tick), not a
    # batch-wide budget raise.
    esc_lanes: int = 0
    esc_sqp_iters: int = 6
    esc_qp_iters: int = 8
    # a lane is retried only while its consecutive-failure streak is
    # below this: structurally infeasible scenes (iteration-insensitive
    # slack activation) stop firing the retry branch after esc_streak_limit
    # ticks; budget misses are fresh failures and always qualify
    esc_streak_limit: int = 3
    # consecutive failed ticks before the tick is treated as DEEP failure
    # (safe-stop braking engages + the re-anchor becomes eligible).
    # 0 = legacy n-2 (ride the whole stale horizon out, reference
    # semantics `BoundMPC.py:728-733`). A long-horizon diagnosis
    # showed n-2=13 lets a failing marginal
    # scene replay an accelerating stale plan for 1.3 s while the
    # attempted-solve violation grows 0.07 -> 4.2; a shallower bar
    # brakes (and re-anchors) within a few ticks instead
    deep_fail_ticks: int = 0
    # fallback collision guard (round 5; exceeds the reference's blind
    # stale-plan replay, `BoundMPC.py:728-733`): on a FAILED tick, if the
    # reused horizon's first 3 EE steps would enter an obstacle box,
    # engage safe-stop braking immediately instead of after
    # deep_fail_ticks more replays (motive: a CPU-mesh executed-EE
    # excursion of 3.2 cm into a box). Default ON: it
    # only acts on failed ticks whose replay is provably colliding.
    fallback_guard: bool = True

    def __post_init__(self):
        if not self.weights:
            object.__setattr__(self, "weights", tuple(default_weights()))

    @property
    def weights_array(self) -> np.ndarray:
        return np.asarray(self.weights, dtype=np.float64)


def default_weights() -> np.ndarray:
    """Default objective weights, numerically identical to the reference
    (`util_functions.py:14-48`)."""
    w_p = 0.05
    w_r = 0.1
    w_v_p = 0.1
    w_v_r = 0.01
    w_speed = 0.5
    w_phi = 5.5 * w_speed
    w_dphi = 4.06
    scal = 0.5 / w_phi
    w_phi *= scal
    w_dphi *= scal
    w_dq = 0.001
    w_jerk = 0.0001
    w_term = 1.0
    w_slack = 10.0
    w_dslack = 500.0
    return np.array(
        [w_p, w_r, w_v_p, w_v_r, w_phi, w_dphi, w_dq, w_jerk, w_term, w_slack, w_dslack]
    )


def default_mpc_params() -> MPCParams:
    return MPCParams()


def perf_mpc_params() -> MPCParams:
    """The standard throughput configuration used by bench.py, chip_smoke.py
    and the graft entry — kept identical so the persistent XLA compile
    cache is shared.

    Each knob was adopted by A/B gates on fleet success, max violation and
    path progress (a demo fleet, the CPU obstacle closed-loop scenario and
    a 64-random-scene x 20-tick fleet) and on throughput:
    - warm_shift + sqp_iters=3: shifted warm starts converge faster and
      track better than the unshifted previous solution.
    - qp_iters=4 + qp_gondzio=2: two Gondzio centrality correctors (cheap
      extra solves against the existing factorization) carry the accuracy
      of more IPM iterations with fewer factorizations.
    - qp_bf16 / qp_bf16_rd: the constraint-matrix streams of the search
      direction and of the dual residual's G^T z in bfloat16 with float32
      accumulation; the residual recomputation stays float32, so the
      rounding is bounded per iteration and does not accumulate.
    - struct_ocp (struct_chunked=False): 12-tangent local AD and the
      static bound/slack rows applied structurally inside the IPM; the
      causal chunk split of the Gram cuts FLOPs further but its
      gathers/scatters cost more than they save, so it stays off.
    - deep_fail_ticks=3: engage safe-stop braking (and the in-scan
      re-anchor once at rest) after 3 consecutive failed solves instead
      of riding the full fallback horizon (n-2 = 13 ticks, reference
      semantics `BoundMPC.py:728-733`); it bounds a marginal scene's
      failure spiral. In-scan budget escalation (esc_lanes>0) stays off:
      at batch <= 128 a retry costs a full extra tick for little success.

    None of these values has been re-gated on the H100 (PERF.md)."""
    return MPCParams(sqp_iters=3, qp_iters=4, qp_gondzio=2,
                     line_search_steps=4,
                     warm_shift=True, qp_bf16=True,
                     qp_bf16_rd=True,
                     struct_ocp=True, struct_chunked=False,
                     deep_fail_ticks=3)


@dataclasses.dataclass(frozen=True)
class PlannerParams:
    """Static planner configuration (reference `BoundPlanner.py:27-58`)."""

    e_p_max: float = 0.5
    obs_size_increase: float = 0.08
    workspace_max: Tuple[float, float, float] = (1.0, 1.0, 1.2)
    workspace_min: Tuple[float, float, float] = (-1.0, -1.0, 0.0)
    max_set_size: int = PLANNER_SET_ROWS
    length_ee: float = 0.05
    max_iters: int = 20
    nr_optimized: int = 10
    nr_free_mid: int = 5
    max_samples: int = 500
    w_size: float = 0.1
    c_fit: float = 1.0
    w_bias: float = 0.01
