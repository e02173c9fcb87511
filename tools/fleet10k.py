"""BASELINE config 5: 10k+ parallel planner+MPC rollouts.

Drives the rungs of the 10k-fleet story end to end and prints each result
as one JSON line:

1. ``build``  — plan the 10240-scene randomized fleet with the process-pool
   planner (`parallel.fleet.build_fleet_mp` via `fleet_cache`); CPU-only.
2. ``gpu``    — closed-loop rollout of all 10240 scenes on one GPU
   (`parallel.batch.chunked_rollout`, one compiled 128-wide program
   lax.map'ed over 80 chunks) with fleet quality gates.
3. ``dist``   — multi-process tier: the same fleet rolled by N coordinated
   processes (`parallel.distributed`), here on a virtual CPU mesh
   (scenario axis over all devices, cross-process diagnostics reductions).

Usage:
    python tools/fleet10k.py gpu   [ticks=10]
    python tools/fleet10k.py dist  [ticks=2] [nproc=2] [devices_per_proc=4]
    python tools/fleet10k.py dist-worker <ticks>   (internal)

Ref: SURVEY.md §7 phase 7, BASELINE.md config 5.
"""

import json
import os
import sys
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)

BATCH, SEED, NR_SEGS = 10240, 7, 4


def _record(key, payload):
    print(json.dumps({key: payload}), flush=True)


def _load_fleet():
    from boundplanner_tpu.parallel.fleet_cache import cache_path, load

    return load(cache_path(BATCH, SEED, NR_SEGS))


def main_gpu(ticks: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from boundplanner_tpu import compile_cache
    from boundplanner_tpu.config import perf_mpc_params

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"the gpu rung needs a GPU; JAX reports {dev.platform!r}")
    from boundplanner_tpu.parallel.batch import chunked_rollout

    cfg = perf_mpc_params()
    fleet = _load_fleet()
    cb = jax.device_put(fleet["carry"])
    ob = jax.device_put(fleet["obs"])
    qb = jax.device_put(jnp.asarray(fleet["q0"]))
    roll = jax.jit(lambda c, q, o: chunked_rollout(c, q, o, cfg, ticks, chunk=128))
    final, recs = roll(cb, qb, ob)
    _ = float(np.asarray(recs["phi"])[0, -1])  # compile + warm sync
    t0 = time.perf_counter()
    final, recs = roll(cb, qb, ob)
    _ = float(np.asarray(recs["phi"])[0, -1])
    wall = time.perf_counter() - t0
    succ = np.asarray(recs["success"], np.float32)
    viol = np.asarray(recs["viol"])
    per_scene_v = viol.max(axis=1)
    per_scene_fail = (1.0 - succ).sum(axis=1)
    _record("gpu_rollout", {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "batch": BATCH,
        "ticks": ticks,
        "wall_s": round(wall, 2),
        "solves_per_s": round(BATCH * ticks / wall, 1),
        "success_rate": round(float(succ.mean()), 4),
        "max_viol": round(float(viol.max()), 6),
        "mean_phi_final": round(float(np.mean(np.asarray(recs["phi"])[:, -1])), 4),
        # per-scene characterization: "structural" scenes fail every tick
        # with a small bounded slack violation (tight corridors, README
        # "hard fleet" class); what matters at fleet scale is how many
        # scenes exceed perception-level violation and how many spiral
        "scenes_failing_any_tick": int((per_scene_fail > 0).sum()),
        "scenes_failing_all_ticks": int((per_scene_fail == ticks).sum()),
        "scenes_viol_gt_1cm": int((per_scene_v > 1e-2).sum()),
        "scenes_viol_gt_10cm": int((per_scene_v > 0.1).sum()),
        "viol_p99": round(float(np.percentile(per_scene_v, 99)), 8),
        "viol_p999": round(float(np.percentile(per_scene_v, 99.9)), 6),
    })


def main_dist(ticks: int, nproc: int, devices_per_proc: int):
    from boundplanner_tpu.parallel.distributed import launch

    t0 = time.perf_counter()
    results = launch(
        [sys.executable, os.path.abspath(__file__), "dist-worker", str(ticks)],
        nproc,
        env_extra={
            "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices_per_proc}",
        },
        timeout=12000,
    )
    wall = time.perf_counter() - t0
    diag = None
    profs = []
    for rc, out in results:
        # a crashed worker must not leave a "successful" artifact built
        # from its peers' partial DIAG lines
        assert rc == 0, f"dist worker failed (rc={rc}):\n{out[-2000:]}"
        for line in out.splitlines():
            if line.startswith("PROF "):
                profs.append(json.loads(line[5:]))
            if line.startswith("DIAG "):
                d = json.loads(line[5:])
                if diag is None:
                    diag = d
                else:
                    # DCN-reduced diagnostics must agree across processes
                    assert all(abs(diag[k] - d[k]) < 1e-6 for k in diag), (diag, d)
    assert diag is not None, "no worker reported diagnostics"
    t_steady = max(p["t_steady_s"] for p in profs)
    _record("dist_rollout", {
        "processes": nproc,
        "devices_per_process": devices_per_proc,
        "batch": BATCH,
        "ticks": ticks,
        "wall_s": round(wall, 2),
        # steady-state rollout wall (slowest process, compile excluded —
        # workers persist compiles in the compile cache, so a warm
        # deployment pays t_steady, not wall)
        "steady_wall_s": round(t_steady, 2),
        "steady_solves_per_s": round(BATCH * ticks / t_steady, 1),
        "t_first_s": max(p["t_first_s"] for p in profs),
        **{k: round(v, 6) for k, v in diag.items()},
    })


def main_dist_worker(ticks: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from boundplanner_tpu import compile_cache
    from boundplanner_tpu.parallel import distributed as dist

    compile_cache.enable()  # per-process compiles otherwise repeat every run

    dist.initialize()
    from boundplanner_tpu.config import perf_mpc_params

    cfg = perf_mpc_params()
    fleet = _load_fleet()
    sl = dist.local_batch_slice(BATCH)
    carry_l = jax.tree.map(lambda x: x[sl], fleet["carry"])
    obs_l = jax.tree.map(lambda x: x[sl], fleet["obs"])
    q0_l = fleet["q0"][sl]
    t0 = time.perf_counter()
    _, _, diag = dist.distributed_rollout(carry_l, q0_l, obs_l, cfg, ticks)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, diag = dist.distributed_rollout(carry_l, q0_l, obs_l, cfg, ticks)
    t_steady = time.perf_counter() - t0
    # PROF is per-process (walls differ); DIAG must bit-agree across procs
    print("PROF " + json.dumps(
        {"t_first_s": round(t_first, 2), "t_steady_s": round(t_steady, 2)}
    ), flush=True)
    print("DIAG " + json.dumps(diag), flush=True)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "gpu":
        main_gpu(int(sys.argv[2]) if len(sys.argv) > 2 else 10)
    elif mode == "dist":
        main_dist(
            int(sys.argv[2]) if len(sys.argv) > 2 else 2,
            int(sys.argv[3]) if len(sys.argv) > 3 else 2,
            int(sys.argv[4]) if len(sys.argv) > 4 else 4,
        )
    elif mode == "dist-worker":
        main_dist_worker(int(sys.argv[2]))
    else:
        raise SystemExit(f"unknown mode {mode!r}")
