"""Batched SQP solve of the condensed BoundMPC OCP.

Fills the role of Ipopt in the reference (`BoundMPC.py:594-603`) via the
generic Gauss-Newton SQP engine (`ops.sqp`): exact residual Jacobians by
``jacfwd`` (the objective is written exactly as a sum of squares), exact
constraint linearization, dense IPM subproblems, l1-merit line search.
Warm starting carries the previous decision vector exactly like the
reference carries ``prev_solution`` (`BoundMPC.py:193-198,412-428`).
"""

from __future__ import annotations

import functools

import jax

from ..config import MPCParams
from ..ops.sqp import SQPResult, gauss_newton_sqp
from . import ocp, ocp_jac, ocp_struct


@functools.partial(jax.jit, static_argnames=("cfg",))
def solve_sqp(x0, params, cfg: MPCParams) -> SQPResult:
    if cfg.struct_ocp:
        eval_jac_fn = lambda x: ocp_jac.evaluate_with_jac_structured(
            x, params, cfg
        )
    elif cfg.manual_jac:
        eval_jac_fn = lambda x: ocp_jac.evaluate_with_jac(x, params, cfg)
    else:
        eval_jac_fn = None
    use_struct = cfg.struct_ocp and cfg.struct_tail
    if cfg.struct_link and not (use_struct and not cfg.struct_chunked):
        # ValueError, not assert: `python -O` strips asserts, and a
        # struct_link+struct_chunked config would silently hit the
        # wrong-Gram path (`ocp_struct.gram_g` row-layout invariant).
        raise ValueError(
            "struct_link requires struct_tail=True, struct_chunked=False"
        )
    return gauss_newton_sqp(
        eval_fn=lambda x: ocp.evaluate(x, params, cfg),
        eval_jac_fn=eval_jac_fn,
        struct=(
            ocp_struct.build(cfg.n, cfg.dt, cfg.struct_chunked)
            if use_struct
            else None
        ),
        x0=x0,
        iters=cfg.sqp_iters,
        qp_iters=cfg.qp_iters,
        line_search_steps=cfg.line_search_steps,
        merit_penalty=cfg.merit_penalty,
        viol_tol=1e-4,
        qp_solver=cfg.qp_solver,
        admm_iters=cfg.admm_iters,
        qp_lowp=cfg.qp_bf16,
        kkt_every=cfg.kkt_every,
        qp_gondzio=cfg.qp_gondzio,
        qp_warm_dual=cfg.qp_warm_dual,
        qp_warm_sz=cfg.qp_warm_sz,
        qp_lowp_rd=cfg.qp_bf16_rd,
        link_a=params["a_set_joints"] if cfg.struct_link else None,
    )
