"""Headline benchmark: BoundMPC solves/s per GPU on a RANDOMIZED fleet.

Measures sustained throughput of the full closed-loop pipeline — fused MPC
tick (condensed Gauss-Newton SQP + per-tick link collision sets + switching
logic) plus plant integration — as ONE compiled scan of T dependent control
periods over a batch of distinct randomized scenes (planner-built tabletop
scenes with obstacles; cached by `parallel.fleet_cache`, built in a CPU
subprocess on first use). A single dispatch with an in-program dependency
chain makes the timing immune to async-dispatch artifacts.

Also reports:
- fleet quality gates measured on the SAME run (success rate, max
  constraint violation, mean path progress) — the throughput number is
  only meaningful if the solves are good;
- the single-scene per-tick latency distribution (p50/p99 over repeated
  single-tick dispatches) against the reference's 0.1 s real-time budget.

Baseline: the reference runs ONE Ipopt solve per 0.1 s real-time budget per
CPU (`utils/util_functions.py:49`, `MPCNode.py:160`), i.e. 10 solves/s;
``vs_baseline`` is the speedup over that.

Usage: python bench.py [batch=128] [ticks=20] [demo]  ("demo" = legacy
homogeneous-scene mode). Prints exactly one JSON line.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

FLEET_SEED = 7
LATENCY_REPS = 200


def main():
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu import compile_cache
    from boundplanner_tpu.config import perf_mpc_params
    from boundplanner_tpu.parallel.batch import fleet_rollout, chunked_rollout

    compile_cache.enable()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX reports {dev.platform!r}")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "--id=0"], capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()

    args = [a for a in sys.argv[1:] if not a.startswith("-")]
    demo_mode = "demo" in args
    args = [a for a in args if a != "demo"]
    batch = int(args[0]) if len(args) > 0 else 128
    ticks = int(args[1]) if len(args) > 1 else 20

    cfg = perf_mpc_params()
    # A/B experiment overrides (adoption decisions still go through
    # perf_mpc_params + the full gate ledger): BENCH_OVERRIDES is a
    # comma-separated knob=value list, e.g.
    #   BENCH_OVERRIDES=esc_lanes=4,qp_iters=4,qp_warm_sz=1
    overrides = os.environ.get("BENCH_OVERRIDES")
    if overrides:
        import dataclasses

        kv = {}
        for item in overrides.split(","):
            key, val = item.split("=")
            cur = getattr(cfg, key)
            kv[key] = type(cur)(int(val) if val.isdigit() else val)
        cfg = dataclasses.replace(cfg, **kv)
        print(f"# overrides: {kv}", file=sys.stderr)

    if demo_mode:
        from boundplanner_tpu.demo import demo_scene, stack_scenes

        carry, meas, obs, q0 = demo_scene(cfg, dtype=np.float32)
        cb, mb, ob = stack_scenes(carry, meas, obs, batch)
        q0b = np.broadcast_to(np.asarray(q0, np.float32), (batch, 7)).copy()
    else:
        from boundplanner_tpu.parallel.fleet_cache import ensure

        fleet = ensure(batch, FLEET_SEED, cfg.nr_segs)
        cb, q0b, ob = fleet["carry"], fleet["q0"], fleet["obs"]

    cb = jax.device_put(cb)
    ob = jax.device_put(ob)
    q0b = jax.device_put(jnp.asarray(q0b))

    chunk = min(batch, 128)
    roll = jax.jit(
        lambda c, q, o: chunked_rollout(c, q, o, cfg, ticks, chunk=chunk)
    )

    # compile + warm up (forces a real sync via scalar fetch)
    final, recs = roll(cb, q0b, ob)
    _ = float(recs["phi"][0, -1])

    trace_dir = os.environ.get("BENCH_TRACE_DIR")
    if trace_dir:
        with jax.profiler.trace(trace_dir):
            final, recs = roll(cb, q0b, ob)
            _ = float(recs["phi"][0, -1])

    t0 = time.perf_counter()
    final, recs = roll(cb, q0b, ob)
    _ = float(recs["phi"][0, -1])
    wall = time.perf_counter() - t0

    solves_per_s = batch * ticks / wall
    success_rate = float(np.mean(np.asarray(recs["success"], np.float32)))
    max_viol = float(np.max(np.asarray(recs["viol"])))
    mean_phi = float(np.mean(np.asarray(recs["phi"])[:, -1]))

    # --- single-scene per-tick latency distribution (0.1 s budget) ---
    # a batch-1 rollout of one tick: the program a single robot runs
    one = jax.tree.map(lambda x: x[:1], (cb, q0b, ob))
    lat_roll = jax.jit(lambda c, q, o: fleet_rollout(c, q, o, cfg, 1))
    _, r1 = lat_roll(*one)
    _ = float(np.asarray(r1["phi"]).ravel()[-1])  # compile + warm
    lats = []
    for _i in range(LATENCY_REPS):
        t0 = time.perf_counter()
        _, r1 = lat_roll(*one)
        _ = float(np.asarray(r1["phi"]).ravel()[-1])
        lats.append(time.perf_counter() - t0)
    lats_ms = 1e3 * np.asarray(lats)

    print(
        json.dumps(
            {
                "metric": "boundmpc_solves_per_s_per_chip",
                "value": round(solves_per_s, 2),
                "unit": "solves/s",
                "vs_baseline": round(solves_per_s / 10.0, 2),
                "workload": "demo" if demo_mode else f"random_fleet_{batch}",
                "ticks": ticks,
                "success_rate": round(success_rate, 4),
                "max_viol": round(max_viol, 6),
                "mean_phi_final": round(mean_phi, 4),
                "tick_latency_ms_p50": float(np.percentile(lats_ms, 50)),
                "tick_latency_ms_p95": float(np.percentile(lats_ms, 95)),
                "tick_latency_ms_p99": float(np.percentile(lats_ms, 99)),
                "tick_latency_ms_max": float(np.max(lats_ms)),
                "latency_reps": int(LATENCY_REPS),
                "latency_budget_ms": 100.0,
                "platform": dev.platform,
                "device_kind": dev.device_kind,
                "device_count": len(jax.devices()),
                "nvidia_smi_name_power_limit": power,
            }
        )
    )


if __name__ == "__main__":
    main()
