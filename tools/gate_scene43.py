"""Scene-43 replay gate (GPU): the marginal fleet scene that is
rounding-sensitive — replays 30 closed-loop ticks of
scene 43 of the checked-in 128-scene fleet at batch-1 vmap on the real
backend and prints the phi/viol/success series.

Bar: the scene must TRACK (phi grows monotonically, viol stays sub-cm,
no persistent-fallback collapse). Usage: python tools/gate_scene43.py
[scene=43] [ticks=30].
"""
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
    scene = int(sys.argv[1]) if len(sys.argv) > 1 else 43
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    cfg = perf_mpc_params()
    fleet = ensure(128, 7, cfg.nr_segs)
    pick = lambda x: x[scene:scene + 1]  # noqa: E731
    cb = jax.tree.map(pick, fleet["carry"])
    ob = jax.tree.map(pick, fleet["obs"])
    q0b = fleet["q0"][scene:scene + 1]
    roll = jax.jit(
        lambda c, q, o: fleet_rollout(c, jnp.asarray(q), o, cfg, ticks)
    )
    final, recs = roll(cb, q0b, ob)
    for k in ["phi", "viol", "success"]:
        print(k, np.round(np.asarray(recs[k], np.float64)[0], 3).tolist())
    v = np.asarray(recs["viol"])[0]
    s = np.asarray(recs["success"], np.float64)[0]
    phi = np.asarray(recs["phi"])[0]
    print("SUMMARY scene=%d ticks=%d max_viol=%.4f success=%.4f phi_final=%.3f"
          % (scene, ticks, float(v.max()), float(s.mean()), float(phi[-1])))


if __name__ == "__main__":
    main()
