"""Build-and-cache randomized planner fleets for the benchmark.

Planning is host-side numpy/CPU work (graph growth over small kernels).
The benchmark builds its randomized fleet ONCE in a CPU subprocess — a
second JAX process on the GPU would find most of the card's memory
reserved by the benchmark process — and caches the stacked pytrees
(pickle of numpy-leaf NamedTuples, schema tagged). Cache files live in `.fleet_cache/` at the repo root and are
keyed by (batch, seed, nr_segs, dtype).

CLI (run with JAX_PLATFORMS=cpu):  python -m boundplanner_tpu.parallel.fleet_cache 128 0 out.pkl
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys

import numpy as np

SCHEMA = "fleet_cache_v1"


def cache_path(batch: int, seed: int, nr_segs: int, root: str | None = None) -> str:
    root = root or os.path.join(os.path.dirname(__file__), "..", "..", ".fleet_cache")
    return os.path.abspath(
        os.path.join(root, f"fleet_b{batch}_s{seed}_segs{nr_segs}.pkl")
    )


def build_and_save(batch: int, seed: int, path: str, n_threads: int = 8,
                   dtype=np.float32):
    """Plan the fleet and pickle it. Must run on a CPU backend.

    Small fleets use the broker-coalesced thread builder; large fleets
    (>=512) use the process-pool builder (`fleet.build_fleet_mp`), whose
    throughput scales with host cores instead of being GIL-bound."""
    from ..config import perf_mpc_params

    cfg = perf_mpc_params()
    if batch >= 512:
        from .fleet import build_fleet_mp

        carry_b, q0_b, obs_b, info = build_fleet_mp(
            batch, cfg, seed=seed, dtype=dtype
        )
        stats = info
    else:
        from .fleet import build_fleet_threaded

        carry_b, q0_b, obs_b, brk = build_fleet_threaded(
            batch, cfg, seed=seed, dtype=dtype, n_threads=n_threads
        )
        stats = {
            "calls_served": brk.calls_served,
            "batches_run": brk.batches_run,
            "coalesced_calls": brk.coalesced_calls,
        }
    payload = {
        "schema": SCHEMA,
        "batch": batch,
        "seed": seed,
        "nr_segs": cfg.nr_segs,
        "carry": carry_b,
        "q0": q0_b,
        "obs": obs_b,
        "broker_stats": stats,
    }
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    return payload


def load(path: str):
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("schema") != SCHEMA:
        raise ValueError(f"unexpected fleet cache schema in {path}")
    return payload


def ensure(batch: int, seed: int, nr_segs: int, timeout: float = 3600.0):
    """Return the cached fleet, building it in a CPU subprocess if absent
    (safe to call from the process that holds the GPU)."""
    path = cache_path(batch, seed, nr_segs)
    if not os.path.exists(path):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        repo_root = os.path.abspath(
            os.path.join(os.path.dirname(__file__), "..", "..")
        )
        subprocess.run(
            [sys.executable, "-m", "boundplanner_tpu.parallel.fleet_cache",
             str(batch), str(seed), path],
            check=True,
            timeout=timeout,
            env=env,
            cwd=repo_root,
        )
    return load(path)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    b, s, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    payload = build_and_save(b, s, out)
    print(f"fleet cache: {b} scenes -> {out} "
          f"(broker: {payload['broker_stats']})")
