"""Randomized-scene fleet example — BASELINE configs 4/5.

Plans N randomized scenes on the host, then rolls the whole fleet
closed-loop on device (chunked: one 128-wide compiled program serves any
fleet size). On several GPUs, shard with
``parallel.mesh.shard_batch`` first.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp

from boundplanner_tpu.config import perf_mpc_params
from boundplanner_tpu.parallel.batch import chunked_rollout
from boundplanner_tpu.parallel.fleet import build_fleet


def main(batch: int = 16, ticks: int = 10, chunk: int = 8):
    chunk = min(chunk, batch)
    cfg = perf_mpc_params()
    print(f"planning {batch} randomized scenes ...")
    t0 = time.time()
    carry_b, q0_b, obs_b = build_fleet(batch, cfg, n_obstacles=2, seed=0)
    print(f"planned in {time.time() - t0:.1f}s")

    roll = jax.jit(
        lambda c, q, o: chunked_rollout(c, q, o, cfg, ticks, chunk=chunk)
    )
    t0 = time.time()
    final, recs = roll(carry_b, jnp.asarray(q0_b), obs_b)
    phi_last = np.asarray(recs["phi"])[:, -1]
    wall = time.time() - t0
    print(
        f"rolled {batch} scenes x {ticks} ticks in {wall:.2f}s "
        f"({batch * ticks / wall:.0f} solves/s incl. compile)"
    )
    print(f"success rate: {np.mean(np.asarray(recs['success'])):.2f}")
    print(f"mean phi progress: {phi_last.mean():.4f}")


if __name__ == "__main__":
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    main(batch)
