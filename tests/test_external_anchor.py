"""External-solver anchor for the condensed BoundMPC OCP.

BASELINE's north star is "control-trajectory parity vs Ipopt at equal
horizon". Ipopt is not installable here, so the 136-var OCP is anchored
against scipy's SLSQP (an independent float64 SQP implementation) on the
EXACT same NLP (`ocp.cost` / `ocp.constraints`, full horizon N=15,
~2.4k inequality rows): same parameters, same warm start, trajectories
must agree and our Gauss-Newton SQP must not converge to a worse point.

This is the test the self-golden regression harness
(`test_golden_regression.py`) cannot provide — it would fail if the SQP
quietly converged to a poorer optimum.
"""

import numpy as np
import pytest
from scipy.optimize import minimize

import jax
import jax.numpy as jnp

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.demo import demo_scene
from boundplanner_tpu.mpc import ocp, ocp_jac
from boundplanner_tpu.mpc.bound_mpc import build_tick_params, mpc_tick
from boundplanner_tpu.mpc.solver import solve_sqp
from boundplanner_tpu.robot import kinematics as kin
from boundplanner_tpu.utils.integration import integrate_jerk_step

CFG = MPCParams()  # default quality config, float64 under the test x64 mode


def _solve_both(params, x0):
    """(our solution, slsqp solution) of the identical NLP from the
    identical start."""
    ours = jax.jit(lambda x, p: solve_sqp(x, p, CFG))(jnp.asarray(x0), params)

    cost_j = jax.jit(lambda x: ocp.cost(x, params, CFG))
    grad_j = jax.jit(jax.grad(lambda x: ocp.cost(x, params, CFG)))
    con_j = jax.jit(lambda x: -ocp.constraints(x, params, CFG))
    conjac_j = jax.jit(lambda x: -ocp_jac.evaluate_with_jac(x, params, CFG)[3])
    res = minimize(
        lambda x: float(cost_j(x)),
        np.asarray(x0),
        jac=lambda x: np.asarray(grad_j(x)),
        constraints=[{
            "type": "ineq",
            "fun": lambda x: np.asarray(con_j(x)),
            "jac": lambda x: np.asarray(conjac_j(x)),
        }],
        method="SLSQP",
        options={"maxiter": 400, "ftol": 1e-10},
    )
    assert res.status == 0, (res.status, res.message)
    return ours, res, cost_j, con_j


def _assert_anchored(params, x0, q_atol=1e-3, p_atol=5e-4):
    ours, res, cost_j, con_j = _solve_both(params, x0)
    assert bool(ours.success)
    x_o, x_r = np.asarray(ours.x), res.x

    viol_o = float(np.max(-np.asarray(con_j(x_o))))
    viol_r = float(np.max(-np.asarray(con_j(x_r))))
    assert viol_o < 1e-5, viol_o
    assert viol_r < 1e-5, viol_r

    c_o, c_r = float(cost_j(x_o)), float(cost_j(x_r))
    # our SQP must not be converging to a WORSE point than the
    # independent solver (being marginally better is fine)
    assert c_o <= c_r * 1.001 + 1e-8, (c_o, c_r)

    tr_o = jax.tree.map(np.asarray, ocp.rollout(jnp.asarray(x_o), params, CFG))
    tr_r = jax.tree.map(np.asarray, ocp.rollout(jnp.asarray(x_r), params, CFG))
    np.testing.assert_allclose(tr_o["q"], tr_r["q"], atol=q_atol, rtol=0)
    np.testing.assert_allclose(
        tr_o["p"][:, :3], tr_r["p"][:, :3], atol=p_atol, rtol=0
    )
    return c_o, c_r


def test_cold_start_tick_matches_slsqp():
    carry, meas, obs, _ = demo_scene(CFG, dtype=np.float64)
    params = jax.jit(lambda c, m, o: build_tick_params(c, m, o, CFG)[0])(
        carry, meas, obs
    )
    x0 = np.zeros(ocp.n_vars(CFG.n))
    c_o, c_r = _assert_anchored(params, x0)
    # the two independent solvers agree on the optimal value itself
    np.testing.assert_allclose(c_o, c_r, rtol=1e-5)


@pytest.mark.slow
def test_five_tick_closed_loop_matches_slsqp():
    """First 5 ticks of the demo tracking scenario: at every tick, the
    fused solve and SLSQP agree from the same (warm) start; the plant then
    advances with OUR control, as in the real loop."""
    carry, meas, obs, q0 = demo_scene(CFG, dtype=np.float64)
    params_fn = jax.jit(lambda c, m, o: build_tick_params(c, m, o, CFG)[0])
    tick_fn = jax.jit(lambda c, m, o: mpc_tick(c, m, o, CFG))

    q, dq, ddq = q0.astype(np.float64), np.zeros(7), np.zeros(7)
    jerk = np.zeros(7)
    qf = q.copy()
    for tick in range(5):
        pose = np.asarray(kin.fk_pose(jnp.asarray(q)))
        v0 = np.asarray(kin.jacobian_fk(jnp.asarray(q)) @ dq)
        meas = {
            "q0": q, "dq0": dq, "ddq0": ddq, "p0": pose, "v0": v0,
            "u0": jerk, "qf": qf,
        }
        meas = {k: jnp.asarray(v) for k, v in meas.items()}
        params = params_fn(carry, meas, obs)
        x0 = np.asarray(carry.x_prev) if bool(carry.has_prev) else np.zeros(
            ocp.n_vars(CFG.n)
        )
        # later ticks sit in a flatter cost valley: allow ~0.3 deg / 2 mm
        # trajectory slack (the cost comparison stays the sharp anchor)
        _assert_anchored(params, x0, q_atol=5e-3, p_atol=2e-3)

        carry, out = tick_fn(carry, meas, obs)
        assert bool(out["success"]), f"tick {tick} infeasible"
        u0, u1 = np.asarray(out["dddq"][0]), np.asarray(out["dddq"][1])
        q, dq, ddq = (
            np.asarray(a)
            for a in integrate_jerk_step(
                jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
                jnp.asarray(u0), jnp.asarray(u1), CFG.dt,
            )
        )
        jerk = u1
        qf = np.asarray(out["q"][-1])


@pytest.mark.slow
def test_hard_scene_failing_tick_anchored():
    """An external anchor on a failing tick
    of a 5-obstacle corridor scene. Building it FALSIFIED the round-2
    reading: the sub-cm-violation ticks of the hard fleet are NOT
    structural infeasibility — SLSQP reaches a fully feasible point
    (viol ~5e-12) where the throughput config (sqp_iters=3, qp_iters=5,
    gondzio=1) leaves ~6e-4; escalating our own budget to sqp_iters=6,
    qp_iters=8 also solves the tick exactly (viol 0, cost 5.5555 —
    matching SLSQP). The correct claim, pinned here: those ticks are
    ITERATION-BUDGET misses, a measured throughput/quality tradeoff whose
    single-tick failures the closed-loop fallback absorbs.

    Asserts (a) the perf-budget solve fails on the pinned tick, (b) SLSQP
    proves the tick feasible, (c) our escalated budget matches SLSQP's
    optimum on this genuinely hard scene — the hard-scene anchor."""
    from boundplanner_tpu.demo import DEMO_Q0
    from boundplanner_tpu.parallel.fleet import plan_scene, random_scene
    from scipy.optimize import minimize

    # perf iteration counts in f64 (x64 disables the bf16 knobs); same
    # config used by the offline finder that located this tick
    cfg = MPCParams(sqp_iters=3, qp_iters=5, qp_gondzio=1,
                    line_search_steps=4, warm_shift=True,
                    struct_ocp=True, struct_chunked=False)
    draw, fail_tick = 8, 2  # found offline: viol ~6e-4 at tick 2
    rng = np.random.default_rng(7 + 1000 * draw)
    obstacles, goal = random_scene(rng, 5)
    planned = plan_scene(DEMO_Q0.copy(), goal, obstacles, 7 + draw, cfg,
                         np.float64)
    assert planned is not None
    carry, obs = jax.device_put(planned[0]), jax.device_put(planned[1])

    tick_fn = jax.jit(lambda c, m, o: mpc_tick(c, m, o, cfg))
    params_fn = jax.jit(lambda c, m, o: build_tick_params(c, m, o, cfg)[0])

    q, dq, ddq = DEMO_Q0.astype(np.float64), np.zeros(7), np.zeros(7)
    jerk, qf = np.zeros(7), DEMO_Q0.astype(np.float64)
    for tick in range(fail_tick + 1):
        pose = np.asarray(kin.fk_pose(jnp.asarray(q)))
        v0 = np.asarray(kin.jacobian_fk(jnp.asarray(q)) @ dq)
        meas = {k: jnp.asarray(v) for k, v in {
            "q0": q, "dq0": dq, "ddq0": ddq, "p0": pose, "v0": v0,
            "u0": jerk, "qf": qf,
        }.items()}
        if tick == fail_tick:
            params = params_fn(carry, meas, obs)
            x_warm = np.asarray(
                ocp.shift_warm_start(carry.x_prev, cfg)
                if bool(carry.has_prev) else jnp.zeros_like(carry.x_prev)
            )
        carry, out = tick_fn(carry, meas, obs)
        u0, u1 = np.asarray(out["dddq"][0]), np.asarray(out["dddq"][1])
        q, dq, ddq = (np.asarray(a) for a in integrate_jerk_step(
            jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
            jnp.asarray(u0), jnp.asarray(u1), cfg.dt))
        jerk = u1
        qf = np.asarray(out["q"][-1])

    # (a) the pinned tick fails under the throughput budget
    viol_ours_tick = float(out["viol"])
    assert not bool(out["success"]), (
        "the pinned tick no longer fails under the perf budget — refresh "
        f"(draw, fail_tick) with the offline finder (viol {viol_ours_tick})"
    )
    assert viol_ours_tick > 1e-4

    # (b) SLSQP on the identical NLP from the identical warm start
    cost_j = jax.jit(lambda x: ocp.cost(x, params, cfg))
    grad_j = jax.jit(jax.grad(lambda x: ocp.cost(x, params, cfg)))
    con_j = jax.jit(lambda x: -ocp.constraints(x, params, cfg))
    conjac_j = jax.jit(
        lambda x: -ocp_jac.evaluate_with_jac(x, params, cfg)[3]
    )
    res = minimize(
        lambda x: float(cost_j(x)),
        x_warm,
        jac=lambda x: np.asarray(grad_j(x)),
        constraints=[{
            "type": "ineq",
            "fun": lambda x: np.asarray(con_j(x)),
            "jac": lambda x: np.asarray(conjac_j(x)),
        }],
        method="SLSQP",
        options={"maxiter": 400, "ftol": 1e-10},
    )
    assert res.status == 0, (res.status, res.message)
    viol_r = float(np.max(-np.asarray(con_j(res.x))))
    assert viol_r < 1e-5, "SLSQP could not solve the tick either"

    # (c) escalated budget matches the independent solver's optimum
    cfg_hi = MPCParams(sqp_iters=6, qp_iters=8, qp_gondzio=1,
                       line_search_steps=4, warm_shift=True,
                       struct_ocp=True, struct_chunked=False)
    ours_hi = jax.jit(lambda x, p: solve_sqp(x, p, cfg_hi))(
        jnp.asarray(x_warm), params
    )
    assert bool(ours_hi.success)
    viol_hi = float(np.max(-np.asarray(con_j(np.asarray(ours_hi.x)))))
    assert viol_hi < 1e-5
    c_hi, c_r = float(cost_j(np.asarray(ours_hi.x))), float(cost_j(res.x))
    assert c_hi <= c_r * 1.001 + 1e-8, (c_hi, c_r)
