"""Randomized-scene fleets: plan on host, roll out batched on device.

BASELINE configs 4-5 ("Batch-1024 randomized scenes", "Multi-host pod:
10k+ parallel planner+MPC rollouts"): scenes differ in start configuration,
goal pose and obstacle layout. Planning (irregular graph search) runs
host-side per scene; the resulting PathStates/carries/obstacles stack into
batched pytrees that the scenario-sharded closed-loop rollout consumes.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from scipy.spatial.transform import Rotation as SciRotation

from ..config import MPCParams
from ..mpc.bound_mpc import init_carry
from ..path.reference_path import build_path
from ..planner import BoundPlanner
from ..planner.set_finder import build_obstacle_arrays
from ..robot import kinematics as kin

DEFAULT_ER_BOUND = np.array([90, 90, 90, -90, -90, -90]) * np.pi / 180


def random_scene(rng: np.random.Generator, n_obstacles: int = 3):
    """A randomized tabletop scene: floor + boxes, random goal offset."""
    obstacles = [[0.2, -1.0, -0.1, 1.0, 1.0, 0.0]]  # floor
    for _ in range(n_obstacles):
        c = rng.uniform([0.3, -0.6, 0.05], [0.7, 0.1, 0.5])
        h = rng.uniform(0.03, 0.1, 3)
        obstacles.append(list(np.concatenate([c - h, c + h])))
    goal = rng.uniform([0.35, -0.55, 0.15], [0.6, -0.2, 0.6])
    return obstacles, goal


def plan_scene(q0, goal, obstacles, seed: int, cfg: MPCParams, dtype=np.float32,
               broker=None):
    """Plan one scene; returns (carry, obstacle arrays) or None on failure."""
    pose0 = np.array(kin.fk_pose(jnp.asarray(np.asarray(q0, np.float64))))
    p0 = pose0[:3]
    r0 = SciRotation.from_rotvec(pose0[3:]).as_matrix()
    r1 = SciRotation.from_euler("XYZ", [0, 90, 0], degrees=True).as_matrix()
    planner = BoundPlanner(
        e_p_max=0.5,
        obstacles=obstacles,
        workspace_max=[1.0, 0.38, 1.0],
        workspace_min=[-0.14, -1.0, 0.0],
        seed=seed,
        broker=broker,
    )
    try:
        p_via, r_via, bp1_list, sets_via = planner.plan_convex_set_path(
            p0.copy(), np.asarray(goal, float).copy(), r0, r1
        )
    except RuntimeError:
        return None
    a_sets = [x[0] for x in sets_via]
    b_sets = [x[1] for x in sets_via]
    br1 = [np.array([0.0, 0.0, 1.0])] * len(bp1_list)
    erb = [DEFAULT_ER_BOUND] * len(bp1_list)
    path = build_path(
        p_via, r_via, bp1_list, br1, erb, a_sets, b_sets,
        nr_segs=cfg.nr_segs, dtype=dtype,
    )
    carry = init_carry(path, pose0.astype(dtype), cfg, dtype)
    obs = build_obstacle_arrays(obstacles, dtype=dtype)
    return carry, obs


def build_fleet(
    batch: int,
    cfg: MPCParams,
    q0=None,
    n_obstacles: int = 3,
    seed: int = 0,
    dtype=np.float32,
):
    """Plan ``batch`` randomized scenes and stack them into batched pytrees
    (carries, q0s, obstacle arrays). Failed plans are re-drawn."""
    from ..demo import DEMO_Q0

    rng = np.random.default_rng(seed)
    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    carries, obs_list = [], []
    draws = 0
    while len(carries) < batch and draws < batch * 4:
        draws += 1
        obstacles, goal = random_scene(rng, n_obstacles)
        out = plan_scene(q0, goal, obstacles, seed + draws, cfg, dtype)
        if out is None:
            continue
        carries.append(out[0])
        obs_list.append(out[1])
    if len(carries) < batch:
        raise RuntimeError(f"only {len(carries)}/{batch} scenes planned")

    carry_b = jax.tree.map(lambda *xs: np.stack(xs), *carries)
    obs_b = jax.tree.map(lambda *xs: np.stack(xs), *obs_list)
    q0_b = np.broadcast_to(q0.astype(dtype), (batch, 7)).copy()
    return carry_b, q0_b, obs_b


def build_fleet_sync(
    batch: int,
    cfg: MPCParams,
    q0=None,
    n_obstacles: int = 3,
    seed: int = 0,
    dtype=np.float32,
    n_workers: int | None = None,
    max_batch: int = 256,
):
    """Phase-synchronous batched fleet planning (SURVEY.md §7 phase 6).

    Plans ``batch`` randomized scenes with ``n_workers`` cooperating
    threads whose device-kernel calls rendezvous at a barrier
    (`sync_broker.PhaseSyncBroker`): the moment every in-flight scene is
    waiting on a kernel result, all pending same-key requests run as ONE
    chunked vmapped execution. Unlike the linger broker (measured mean
    width 1.2-1.6 on CPU), coalescing width tracks the number of
    in-flight scenes.

    Returns (carry_b, q0_b, obs_b, broker); ``broker.stats`` reports the
    achieved batching widths.
    """
    import threading

    from ..demo import DEMO_Q0
    from .broker import register_planner_kernels
    from .sync_broker import PhaseSyncBroker

    if n_workers is None:
        n_workers = min(batch, max_batch)
    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    brk = PhaseSyncBroker(max_batch=max_batch)
    register_planner_kernels(brk, max_set_size=20)

    results = {}
    lock = threading.Lock()
    counter = {"draw": 0}

    def worker():
        try:
            while True:
                with lock:
                    if len(results) >= batch or counter["draw"] >= batch * 4:
                        return
                    counter["draw"] += 1
                    draw = counter["draw"]
                rng_i = np.random.default_rng(seed + 1000 * draw)
                obstacles, goal = random_scene(rng_i, n_obstacles)
                out = plan_scene(
                    q0, goal, obstacles, seed + draw, cfg, dtype, broker=brk
                )
                if out is not None:
                    with lock:
                        if len(results) < batch:
                            results[draw] = out
        finally:
            brk.worker_exit()

    # register every worker BEFORE any starts, so no early worker sees a
    # momentarily-complete barrier and flushes a narrow batch
    for _ in range(n_workers):
        brk.worker_enter()
    threads = [threading.Thread(target=worker) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(results) < batch:
        raise RuntimeError(f"only {len(results)}/{batch} scenes planned")
    ordered = [results[k] for k in sorted(results)][:batch]
    carry_b = jax.tree.map(lambda *xs: np.stack(xs), *[o[0] for o in ordered])
    obs_b = jax.tree.map(lambda *xs: np.stack(xs), *[o[1] for o in ordered])
    q0_b = np.broadcast_to(q0.astype(dtype), (batch, 7)).copy()
    return carry_b, q0_b, obs_b, brk


def _mp_worker_init(counter, n_cpus):
    """Pool initializer: force the CPU backend and pin the worker to one
    core.

    Workers must never open the GPU: each JAX process that does reserves
    most of the card's memory, so a second one fails for want of memory
    (and would contend with the process that holds the card). The
    JAX_PLATFORMS=cpu the pool is spawned with is repeated here through
    jax.config, which must run before the first backend use. Pinning
    stops the per-process XLA/BLAS pools from migrating and
    spin-contending."""
    import os as _os

    import jax as _jax

    _jax.config.update("jax_platforms", "cpu")
    with counter.get_lock():
        idx = counter.value
        counter.value += 1
    if n_cpus > 0:
        try:
            _os.sched_setaffinity(0, {idx % n_cpus})
        except (AttributeError, OSError):  # pragma: no cover - non-linux
            pass


def _mp_plan_block(args):
    """Plan one block of draws in a worker process (top-level for spawn
    pickling). Returns [(draw, carry, obs)] for the successful draws."""
    draws, q0, n_obstacles, seed, cfg, dtype_name = args
    if jax.default_backend() != "cpu":  # pragma: no cover - misconfig guard
        raise RuntimeError(
            "fleet planning worker must run on the CPU backend, got "
            f"{jax.default_backend()!r} (a second process on the GPU "
            "finds its memory reserved by the first)"
        )
    dtype = np.dtype(dtype_name).type
    out = []
    for draw in draws:
        rng_i = np.random.default_rng(seed + 1000 * draw)
        obstacles, goal = random_scene(rng_i, n_obstacles)
        planned = plan_scene(q0, goal, obstacles, seed + draw, cfg, dtype)
        if planned is not None:
            out.append((draw, planned[0], planned[1]))
    return out


def build_fleet_mp(
    batch: int,
    cfg: MPCParams,
    q0=None,
    n_obstacles: int = 3,
    seed: int = 0,
    dtype=np.float32,
    n_procs: int | None = None,
    block: int = 32,
    pin: bool = True,
    single_thread: bool = True,
    x64: bool = False,
):
    """Plan a LARGE fleet with a pool of CPU worker processes (BASELINE
    config 5 scale: 10k+ scenes).

    Planning is host-python + small jitted CPU kernels; thread-based
    builders are GIL-bound, so for 10k-scene fleets the scaling axis is
    processes. The draw scheme matches `build_fleet_threaded` /
    `build_fleet_sync` (scene ``draw`` uses rng seed ``seed + 1000*draw``,
    planner seed ``seed + draw``), and the result is deterministic
    regardless of scheduling: draws 1..M are planned and the first
    ``batch`` successes in draw order are kept.

    Returns (carry_b, q0_b, obs_b, info) with plans/s in ``info``.
    """
    import multiprocessing as mp
    import os
    import time as _time

    from ..demo import DEMO_Q0

    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    n_procs = n_procs or max(1, (os.cpu_count() or 2))
    # plan a deterministic draw superset with margin for failed plans
    # (measured failure rate is a few %; re-raise if the margin is blown)
    n_draws = batch + max(min(64, batch), batch // 8)
    blocks = [
        list(range(lo + 1, min(lo + block, n_draws) + 1))
        for lo in range(0, n_draws, block)
    ]
    tasks = [
        (d, q0, n_obstacles, seed, cfg, np.dtype(dtype).name) for d in blocks
    ]
    t0 = _time.perf_counter()
    ctx = mp.get_context("spawn")
    results = {}
    # Children must come up on the CPU backend (a JAX process on the GPU
    # reserves most of its memory, so only one may hold the card): module
    # import during task unpickling can initialize JAX's backend before any
    # code of ours runs in the child, so a config.update there is too late
    # — instead flip the env var the child reads at import. Spawn children snapshot the
    # parent's os.environ at launch; the parent's own (already-initialized)
    # backend is unaffected, and the value is restored immediately.
    env_override = {"JAX_PLATFORMS": "cpu"}
    if x64:
        # parity with x64 in-process builds (tests); production fleets for
        # the bench stay f32
        env_override["JAX_ENABLE_X64"] = "1"
    if single_thread:
        # single-threaded XLA/BLAS per worker: the kernels are tiny and the
        # spin-waiting pools of n_procs processes otherwise thrash the cores
        env_override.update(
            XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
            "intra_op_parallelism_threads=1",
            OPENBLAS_NUM_THREADS="1",
            OMP_NUM_THREADS="1",
        )
    # The override is restored as soon as the pool's workers have spawned
    # (all spawn inside the Pool() constructor), NOT after the whole build:
    # anything else in this process that reads these vars or launches
    # subprocesses during a long build must see the original values. A
    # worker respawned later (after a crash) would come up without the
    # override, but `_mp_worker_init`'s jax.config.update still forces the
    # CPU backend there — only its BLAS thread pinning would be lost.
    saved = {k: os.environ.get(k) for k in env_override}
    os.environ.update(env_override)
    counter = ctx.Value("i", 0)
    try:
        pool_cm = ctx.Pool(
            processes=n_procs,
            initializer=_mp_worker_init,
            initargs=(counter, (os.cpu_count() or 1) if pin else 0),
        )
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with pool_cm as pool:
        for blk in pool.imap_unordered(_mp_plan_block, tasks):
            for draw, carry, obs in blk:
                results[draw] = (carry, obs)
    wall = _time.perf_counter() - t0
    if len(results) < batch:
        raise RuntimeError(f"only {len(results)}/{batch} scenes planned")
    ordered = [results[k] for k in sorted(results)[:batch]]
    carry_b = jax.tree.map(lambda *xs: np.stack(xs), *[o[0] for o in ordered])
    obs_b = jax.tree.map(lambda *xs: np.stack(xs), *[o[1] for o in ordered])
    q0_b = np.broadcast_to(q0.astype(dtype), (batch, 7)).copy()
    info = {
        "planned": len(results),
        "draws": n_draws,
        "wall_s": wall,
        "plans_per_s": len(results) / wall,
        "n_procs": n_procs,
    }
    return carry_b, q0_b, obs_b, info


def build_fleet_threaded(
    batch: int,
    cfg: MPCParams,
    q0=None,
    n_obstacles: int = 3,
    seed: int = 0,
    dtype=np.float32,
    n_threads: int = 8,
    linger: float = 0.030,
    device_search: bool = False,
):
    """Like `build_fleet`, but plans scenes on a thread pool whose
    device-kernel calls coalesce through a `broker.BatchBroker` into
    shared vmapped executions (BASELINE config 4: fleet planning
    throughput). Returns (carry_b, q0_b, obs_b, broker) — the broker's
    counters expose how much batching was achieved."""
    import threading

    from ..demo import DEMO_Q0
    from ..planner import BoundPlanner
    from .broker import BatchBroker, register_planner_kernels

    q0 = DEMO_Q0.copy() if q0 is None else np.asarray(q0, float)
    brk = BatchBroker(linger=linger)
    register_planner_kernels(brk, max_set_size=20, device_search=device_search)

    results = {}
    lock = threading.Lock()
    counter = {"draw": 0}

    def worker():
        while True:
            with lock:
                if len(results) >= batch or counter["draw"] >= batch * 4:
                    return
                counter["draw"] += 1
                draw = counter["draw"]
            rng_i = np.random.default_rng(seed + 1000 * draw)
            obstacles, goal = random_scene(rng_i, n_obstacles)
            out = plan_scene(
                q0, goal, obstacles, seed + draw, cfg, dtype, broker=brk
            )
            if out is not None:
                with lock:
                    if len(results) < batch:
                        results[draw] = out

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if len(results) < batch:
        raise RuntimeError(f"only {len(results)}/{batch} scenes planned")
    ordered = [results[k] for k in sorted(results)][:batch]
    carry_b = jax.tree.map(lambda *xs: np.stack(xs), *[o[0] for o in ordered])
    obs_b = jax.tree.map(lambda *xs: np.stack(xs), *[o[1] for o in ordered])
    q0_b = np.broadcast_to(q0.astype(dtype), (batch, 7)).copy()
    return carry_b, q0_b, obs_b, brk
