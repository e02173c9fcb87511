"""Probe the failing fleet scenes under budget escalation.

Rolls a subset of the 128-scene BENCH fleet with `fleet_rollout` at the
perf config, with and without `esc_lanes`, and prints per-scene
chronologies — answers "is this scene's failure an iteration-budget miss
the in-scan escalation closes, or structural?" at scene granularity.

Usage: python tools/probe_escalation.py [scenes=29,43,54] [ticks=50]
       [esc_lanes=4] [esc_sqp=6] [esc_qp=8]
"""
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from boundplanner_tpu import compile_cache  # noqa: E402

compile_cache.enable()

from boundplanner_tpu.config import perf_mpc_params  # noqa: E402
from boundplanner_tpu.parallel.batch import fleet_rollout  # noqa: E402
from boundplanner_tpu.parallel.fleet_cache import ensure  # noqa: E402


def main():
    scenes = [int(s) for s in (sys.argv[1] if len(sys.argv) > 1
                               else "29,43,54").split(",")]
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 50
    esc_lanes = int(sys.argv[3]) if len(sys.argv) > 3 else 4
    esc_sqp = int(sys.argv[4]) if len(sys.argv) > 4 else 6
    esc_qp = int(sys.argv[5]) if len(sys.argv) > 5 else 8

    base = perf_mpc_params()
    cfg = dataclasses.replace(base, esc_lanes=esc_lanes,
                              esc_sqp_iters=esc_sqp, esc_qp_iters=esc_qp)
    fleet = ensure(128, 7, base.nr_segs)
    idx = np.asarray(scenes)
    pick = lambda x: jnp.asarray(np.asarray(x)[idx])  # noqa: E731
    cb = jax.tree.map(pick, fleet["carry"])
    ob = jax.tree.map(pick, fleet["obs"])
    qb = jnp.asarray(np.asarray(fleet["q0"])[idx])

    roll = jax.jit(lambda c, q, o: fleet_rollout(c, q, o, cfg, ticks))
    _, recs = roll(cb, qb, ob)
    recs = jax.tree.map(np.asarray, recs)
    print(f"esc_lanes={esc_lanes} esc=({esc_sqp},{esc_qp}) ticks={ticks}")
    for i, s in enumerate(scenes):
        succ, viol, phi = recs["success"][i], recs["viol"][i], recs["phi"][i]
        f = np.where(~succ)[0]
        print(f"scene {s}: fails {len(f)}/{ticks} at {f[:8].tolist()} "
              f"max_viol {viol.max():.4f} phi_final {phi[-1]:.4f}")
    print("ALL:", "success %.4f" % recs["success"].mean(),
          "max_viol %.6f" % recs["viol"].max())


if __name__ == "__main__":
    main()
