"""Budget escalation on failing ticks (`parallel.batch.fleet_rollout` +
`_escalate_failed_lanes`).

The perf iteration budget leaves ~1% of fleet ticks infeasible; the
hard-scene anchor (tests/test_external_anchor.py) proved those ticks are
iteration-budget misses that the same solver closes at sqp 6 / qp 8
(the reference's Ipopt budget max_iter=100 absorbs them as a matter of
course, ref `bound_planner/BoundMPC/BoundMPC.py:203-206`). The rollout
escalation compacts failing lanes into a fixed sub-batch and re-ticks
them at the escalated budget under a batch-level `lax.cond`.

Mechanics (gather/compact/scatter-with-drop) are unit-tested with an
injected fake tick; the end-to-end rescue runs the REAL hard fleet scene
(slow).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.demo import demo_fleet
from boundplanner_tpu.parallel.batch import (
    _escalate_failed_lanes,
    closed_loop_rollout,
    fleet_rollout,
)

CFG = MPCParams(
    sqp_iters=2, qp_iters=4, line_search_steps=2, warm_shift=True,
    struct_ocp=True, struct_chunked=False,
    esc_lanes=0, esc_sqp_iters=4, esc_qp_iters=8,
)


def test_fleet_rollout_matches_vmap_closed_loop():
    """esc_lanes=0: fleet_rollout (scan-of-vmap) must reproduce the
    existing vmap(closed_loop_rollout) (vmap-of-scan) exactly — same
    ops, different loop nesting order."""
    cfg = CFG
    carry_b, obs_b, q0_b = demo_fleet(cfg, 3, dtype=np.float64)
    q0_b = jnp.asarray(q0_b, np.float64)
    final_a, recs_a = fleet_rollout(carry_b, q0_b, obs_b, cfg, 3)
    final_b, recs_b = jax.vmap(
        lambda c, q, o: closed_loop_rollout(c, q, o, cfg, 3)
    )(carry_b, q0_b, obs_b)
    for ka in recs_a:
        np.testing.assert_allclose(
            np.asarray(recs_a[ka], np.float64),
            np.asarray(recs_b[ka], np.float64),
            rtol=0, atol=0, err_msg=ka,
        )
    jax.tree.map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a, np.float64), np.asarray(b, np.float64),
            rtol=0, atol=0,
        ),
        final_a, final_b,
    )


# ---------------------------------------------------------------------
# mechanics with an injected fake tick: carries/outs are plain arrays

def _fake_state(batch):
    """(carry_in, meas, obs, carry_n, out) built from plain arrays; lane
    identity is encoded in the values so compaction bugs are visible."""
    lane = jnp.arange(batch, dtype=jnp.float64)
    carry_in = {"a": 100.0 + lane, "b": jnp.stack([lane, lane + 0.5], 1)}
    meas = {"m": 200.0 + lane}
    obs = {"o": 300.0 + lane}
    carry_n = {"a": 400.0 + lane, "b": jnp.stack([lane, lane - 0.5], 1)}
    out = {"y": 500.0 + lane}
    return carry_in, meas, obs, carry_n, out


def _fake_tick(c, m, o):
    """Retry tick: marks each retried lane with its gathered inputs so
    the test can verify WHICH pre-tick state was re-ticked."""
    new_c = {"a": c["a"] + 1000.0, "b": c["b"] + 1000.0}
    new_out = {
        "y": c["a"] * 1e6 + m["m"] * 1e3 + o["o"],
        "success": jnp.asarray(True),
    }
    return new_c, new_out


def _run_escalate(fail_mask, esc_lanes, batch=6):
    carry_in, meas, obs, carry_n, out = _fake_state(batch)
    out = dict(out, success=jnp.asarray(~np.asarray(fail_mask)))
    cfg = dataclasses.replace(CFG, esc_lanes=esc_lanes)
    fn = jax.jit(
        lambda ci, m, o, cn, ou: _escalate_failed_lanes(
            ci, m, o, cn, ou, cfg, tick_fn=_fake_tick
        )
    )
    carry2, out2 = fn(carry_in, meas, obs, carry_n, out)
    return jax.tree.map(np.asarray, (carry_in, carry_n, out, carry2, out2))


def test_escalate_retries_only_failed_lanes():
    fail = np.array([False, True, False, True, False, False])
    carry_in, carry_n, out, carry2, out2 = _run_escalate(fail, esc_lanes=4)
    for lane in range(6):
        if fail[lane]:
            # retried from the PRE-tick carry of that lane
            assert carry2["a"][lane] == carry_in["a"][lane] + 1000.0
            expect = (100.0 + lane) * 1e6 + (200.0 + lane) * 1e3 + 300.0 + lane
            assert out2["y"][lane] == expect
            assert bool(out2["success"][lane])
        else:
            # untouched lanes bit-identical (fill scatters dropped)
            assert carry2["a"][lane] == carry_n["a"][lane]
            assert out2["y"][lane] == out["y"][lane]
    np.testing.assert_array_equal(
        carry2["b"][~fail], carry_n["b"][~fail]
    )


def test_escalate_capacity_overflow_keeps_base_fallback():
    fail = np.array([True, True, True, False, False, False])
    carry_in, carry_n, out, carry2, out2 = _run_escalate(fail, esc_lanes=2)
    # first two failing lanes retried, third keeps base outputs
    assert bool(out2["success"][0]) and bool(out2["success"][1])
    assert not bool(out2["success"][2])
    assert out2["y"][2] == out["y"][2]
    assert carry2["a"][2] == carry_n["a"][2]


def test_escalate_no_failures_is_noop():
    fail = np.zeros(6, bool)
    _, carry_n, out, carry2, out2 = _run_escalate(fail, esc_lanes=4)
    np.testing.assert_array_equal(out2["y"], out["y"])
    np.testing.assert_array_equal(carry2["a"], carry_n["a"])


def test_escalate_all_failed_full_capacity():
    fail = np.ones(6, bool)
    carry_in, _, _, carry2, out2 = _run_escalate(fail, esc_lanes=6)
    np.testing.assert_array_equal(
        carry2["a"], carry_in["a"] + 1000.0
    )
    assert bool(np.all(out2["success"]))


# ---------------------------------------------------------------------
# end-to-end rescue on the real hard fleet scene

@pytest.mark.slow
def test_escalation_rescues_hard_scene_tick():
    """The pinned hard fleet scene (draw 8, see test_external_anchor)
    fails a tick under the perf budget; with esc_lanes=1 the rollout
    must escalate that tick in-scan and close the failure."""
    from boundplanner_tpu.demo import DEMO_Q0
    from boundplanner_tpu.parallel.fleet import plan_scene, random_scene

    cfg = MPCParams(sqp_iters=3, qp_iters=5, qp_gondzio=1,
                    line_search_steps=4, warm_shift=True,
                    struct_ocp=True, struct_chunked=False,
                    esc_lanes=0, esc_sqp_iters=6, esc_qp_iters=8)
    draw = 8
    rng = np.random.default_rng(7 + 1000 * draw)
    obstacles, goal = random_scene(rng, 5)
    planned = plan_scene(DEMO_Q0.copy(), goal, obstacles, 7 + draw, cfg,
                         np.float64)
    assert planned is not None
    carry, obs = planned
    cb = jax.tree.map(lambda x: jnp.asarray(np.asarray(x))[None], carry)
    ob = jax.tree.map(lambda x: jnp.asarray(np.asarray(x))[None], obs)
    qb = jnp.asarray(DEMO_Q0, np.float64)[None]

    ticks = 4
    _, recs0 = fleet_rollout(cb, qb, ob, cfg, ticks)
    fails0 = int((~np.asarray(recs0["success"])).sum())
    if fails0 == 0:
        pytest.skip("hard scene no longer fails under the perf budget — "
                    "refresh the pin with tools/find_hard_tick.py")

    cfg_esc = dataclasses.replace(cfg, esc_lanes=1)
    _, recs1 = fleet_rollout(cb, qb, ob, cfg_esc, ticks)
    fails1 = int((~np.asarray(recs1["success"])).sum())
    # escalation changes the closed-loop trajectory, so downstream ticks
    # of this chaotic 5-obstacle scene can fail anew (each a fresh budget
    # miss) — the bar is strict improvement with bounded violations, not
    # perfection (the fleet-level bar lives in the GPU fleet gates)
    assert fails1 < fails0, (fails1, fails0)
    assert float(np.asarray(recs1["viol"]).max()) < 5e-3


def test_escalate_streak_limit_stops_structural_retries():
    """A lane that keeps failing (structural infeasibility) must stop
    being retried once its consecutive-failure streak reaches
    esc_streak_limit — checked through fleet_rollout by counting fake
    retry markers... exercised here at the _escalate level: a lane with
    eligible=False keeps its base outputs even though it failed."""
    fail = np.array([True, False, False, False, False, False])
    carry_in, meas, obs, carry_n, out = _fake_state(6)
    out = dict(out, success=jnp.asarray(~fail))
    cfg = dataclasses.replace(CFG, esc_lanes=2)
    carry2, out2 = _escalate_failed_lanes(
        carry_in, meas, obs, carry_n, out, cfg, tick_fn=_fake_tick,
        eligible=jnp.zeros(6, bool),   # streak exhausted everywhere
    )
    np.testing.assert_array_equal(np.asarray(out2["y"]), np.asarray(out["y"]))
    np.testing.assert_array_equal(
        np.asarray(carry2["a"]), np.asarray(carry_n["a"])
    )
