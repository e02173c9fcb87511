"""Phase-synchronous broker: barrier-flush semantics + fleet parity.

The PhaseSyncBroker replaces the linger-window coalescing of
`parallel.broker.BatchBroker` (measured mean width 1.2-1.6 on 16-scene
fleets) with a barrier: a flush fires exactly when every
registered worker is parked in `call`, so coalescing width tracks the
number of in-flight scenes (SURVEY.md §7 phase 6).
"""

import threading

import numpy as np
import pytest

from boundplanner_tpu.parallel.sync_broker import PhaseSyncBroker


def _run_workers(n, body, brk):
    """Spawner pattern: enter ALL workers before starting any (the
    sync_broker startup contract); each body must worker_exit in finally."""
    errs = []

    def wrapped(i):
        try:
            body(i)
        except Exception as e:  # pragma: no cover - surfaced via raise below
            errs.append(e)

    for _ in range(n):
        brk.worker_enter()
    threads = [threading.Thread(target=wrapped, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errs:
        raise errs[0]


def test_lockstep_workers_coalesce_full_width():
    """4 workers x 3 rounds -> exactly 3 batches, each of width 4."""
    brk = PhaseSyncBroker()
    brk.register("sq", lambda x: x * x)
    results = {}

    def body(i):
        try:
            out = []
            for r in range(3):
                out.append(brk.call("sq", np.full(3, float(10 * i + r))))
            results[i] = out
        finally:
            brk.worker_exit()

    _run_workers(4, body, brk)
    for i in range(4):
        for r in range(3):
            np.testing.assert_allclose(
                results[i][r], np.full(3, float(10 * i + r)) ** 2
            )
    assert brk.calls_served == 12
    assert brk.batches_run == 3
    assert brk.stats["width_hist"] == {4: 3}


def test_irregular_call_counts_no_deadlock():
    """Worker i makes i+1 calls; exits shrink the barrier so later rounds
    flush at the smaller width instead of deadlocking."""
    brk = PhaseSyncBroker()
    brk.register("neg", lambda x: -x)
    results = {}

    def body(i):
        try:
            results[i] = [brk.call("neg", np.arange(3.0) + i + r)
                          for r in range(i + 1)]
        finally:
            brk.worker_exit()

    _run_workers(4, body, brk)
    for i in range(4):
        for r in range(i + 1):
            np.testing.assert_allclose(results[i][r], -(np.arange(3.0) + i + r))
    assert brk.calls_served == 10
    # rounds of width 4, 3, 2, 1 (pow-2 padded to 4, 4, 2, 1)
    assert brk.batches_run == 4
    assert brk.stats["mean_width"] == pytest.approx(2.5)


def test_mixed_keys_flush_together():
    """Different keys pending at the barrier each run as their own batch
    in one flush."""
    brk = PhaseSyncBroker()
    brk.register("sq", lambda x: x * x)
    brk.register("neg", lambda x: -x)
    results = {}

    def body(i):
        try:
            key = "sq" if i % 2 == 0 else "neg"
            results[i] = (key, brk.call(key, np.full(2, float(i + 1))))
        finally:
            brk.worker_exit()

    _run_workers(4, body, brk)
    for i in range(4):
        key, val = results[i]
        exp = np.full(2, float(i + 1))
        np.testing.assert_allclose(val, exp**2 if key == "sq" else -exp)
    assert brk.calls_served == 4
    assert brk.batches_run == 2  # one per key, single flush


def test_single_worker_width_one():
    brk = PhaseSyncBroker()
    brk.register("neg", lambda x: -x)
    brk.worker_enter()
    try:
        out = brk.call("neg", np.arange(4.0))
    finally:
        brk.worker_exit()
    np.testing.assert_allclose(out, -np.arange(4.0))
    assert brk.stats["width_hist"] == {1: 1}


def test_kernel_error_delivered_to_all_parked_callers():
    """A failing batch (here: unstackable shapes) raises in every waiting
    thread instead of deadlocking."""
    brk = PhaseSyncBroker()
    brk.register("sq", lambda x: x * x)
    caught = {}

    def body(i):
        try:
            try:
                brk.call("sq", np.zeros(3 + i))  # shapes (3,) and (4,)
            except Exception as e:
                caught[i] = e
        finally:
            brk.worker_exit()

    _run_workers(2, body, brk)
    assert set(caught) == {0, 1}


def test_unregistered_key_raises():
    brk = PhaseSyncBroker()
    with pytest.raises(KeyError):
        brk.call("nope", np.zeros(3))


def test_chunking_beyond_max_batch():
    """More parked calls than max_batch run in pow-2-padded chunks."""
    brk = PhaseSyncBroker(max_batch=4)
    brk.register("sq", lambda x: x * x)
    results = {}

    def body(i):
        try:
            results[i] = brk.call("sq", np.full(2, float(i)))
        finally:
            brk.worker_exit()

    _run_workers(6, body, brk)
    for i in range(6):
        np.testing.assert_allclose(results[i], np.full(2, float(i)) ** 2)
    assert brk.calls_served == 6
    assert brk.batches_run == 2  # chunks of 4 and 2
    assert brk.stats["width_hist"] == {4: 1, 2: 1}


def test_sync_brokered_planner_matches_direct():
    """One scene planned through the sync broker (single worker) gives the
    same plan as the direct kernel path."""
    from boundplanner_tpu.parallel.broker import register_planner_kernels
    from boundplanner_tpu.planner import BoundPlanner

    obstacles = [
        [0.2, -1.0, -0.1, 1.0, 1.0, 0.0],
        [0.35, -0.25, 0.0, 0.55, -0.1, 0.45],
    ]
    kw = dict(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=[1.0, 0.38, 1.0],
        workspace_min=[-0.14, -1.0, 0.0],
        seed=0,
    )
    p0 = np.array([0.55, 0.0, 0.6])
    p1 = np.array([0.45, -0.4, 0.25])
    from scipy.spatial.transform import Rotation as R

    r0 = R.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()

    direct = BoundPlanner(**kw)
    pv0, rv0, bp0, sets0 = direct.plan_convex_set_path(p0, p1, r0, r0)

    brk = PhaseSyncBroker()
    register_planner_kernels(brk, max_set_size=20)
    brokered = BoundPlanner(**kw, broker=brk)
    brk.worker_enter()
    try:
        pv1, rv1, bp1, sets1 = brokered.plan_convex_set_path(p0, p1, r0, r0)
    finally:
        brk.worker_exit()

    assert len(pv0) == len(pv1)
    for a, b in zip(pv0, pv1):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-8)
    for (a0, b0), (a1, b1) in zip(sets0, sets1):
        np.testing.assert_allclose(a0, a1, atol=1e-8)
        np.testing.assert_allclose(b0, b1, atol=1e-8)
    assert brk.calls_served > 0


@pytest.mark.slow
def test_sync_fleet_build_matches_threaded():
    """build_fleet_sync plans the same draws as build_fleet_threaded (same
    seed scheme) and achieves materially wider batches."""
    from boundplanner_tpu.config import MPCParams
    from boundplanner_tpu.parallel.fleet import (
        build_fleet_sync,
        build_fleet_threaded,
    )

    cfg = MPCParams(sqp_iters=2, qp_iters=5, line_search_steps=2)
    carry_s, q0_s, obs_s, brk_s = build_fleet_sync(
        4, cfg, n_obstacles=2, seed=3, n_workers=4
    )
    carry_t, q0_t, obs_t, brk_t = build_fleet_threaded(
        4, cfg, n_obstacles=2, seed=3, n_threads=4, linger=0.02
    )
    assert q0_s.shape == (4, 7)
    np.testing.assert_allclose(q0_s, q0_t)  # draw scheme identical
    import jax

    # Do NOT compare plan leaves value-wise: the sync builder coalesces
    # planner kernels into width-4 vmapped batches whose float
    # reassociation the planner's discrete decisions can amplify into a
    # different, equally valid plan (see test_mp_fleet_build_matches_direct
    # docstring). Assert structural + quality invariants instead.
    leaves_s = jax.tree.leaves(carry_s)
    leaves_t = jax.tree.leaves(carry_t)
    assert jax.tree.structure(carry_s) == jax.tree.structure(carry_t)
    for ls, lt in zip(leaves_s, leaves_t):
        assert np.asarray(ls).shape == np.asarray(lt).shape
        assert np.isfinite(np.asarray(ls, np.float64)).all()
    # every scene got a real plan: positive path extent
    assert np.all(np.asarray(carry_s.path.phi_max) > 0)
    assert np.all(np.asarray(carry_t.path.phi_max) > 0)
    assert brk_s.calls_served > 0
    assert brk_s.stats["mean_width"] > 1.5  # barrier actually coalesces


@pytest.mark.slow
def test_mp_fleet_build_matches_direct():
    """build_fleet_mp (process pool) reproduces direct in-process planning
    of the same draw scheme bit-for-bit (both use the unbrokered kernel
    path; brokered builders at width>1 may legitimately diverge — vmapped
    batches reassociate float ops and the planner's discrete decisions
    amplify the difference into a different, equally valid plan)."""
    import jax

    from boundplanner_tpu.config import MPCParams
    from boundplanner_tpu.demo import DEMO_Q0
    from boundplanner_tpu.parallel.fleet import (
        build_fleet_mp,
        plan_scene,
        random_scene,
    )

    cfg = MPCParams(sqp_iters=2, qp_iters=5, line_search_steps=2)
    carry_m, q0_m, obs_m, info = build_fleet_mp(
        4, cfg, n_obstacles=2, seed=3, n_procs=2, block=2, x64=True
    )
    assert info["planned"] >= 4

    # direct, same draw scheme (draw 1..): rng seed + 1000*draw, planner
    # seed + draw; first 4 successes in draw order
    direct = []
    draw = 0
    while len(direct) < 4:
        draw += 1
        rng_i = np.random.default_rng(3 + 1000 * draw)
        obstacles, goal = random_scene(rng_i, 2)
        out = plan_scene(DEMO_Q0.copy(), goal, obstacles, 3 + draw, cfg)
        if out is not None:
            direct.append(out)
    carry_d = jax.tree.map(lambda *xs: np.stack(xs), *[o[0] for o in direct])
    for leaf_m, leaf_d in zip(
        jax.tree.leaves(carry_m), jax.tree.leaves(carry_d)
    ):
        np.testing.assert_allclose(leaf_m, leaf_d, atol=1e-7)
