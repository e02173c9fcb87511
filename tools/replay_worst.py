"""Diagnose the long-horizon fleet gate: replay the 128-scene fleet with
EXTENDED per-tick records (error_count, dq, re-anchor trigger state) and
print per-scene failure chronologies for the worst scenes.

It answers WHICH scene/tick regressed when a fleet gate moves, and
whether the in-scan re-anchor cycles park -> re-anchor -> violate, at
scene/tick granularity without touching the bench program (separate
compile).

Usage: python tools/replay_worst.py [ticks=50] [top=3]
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
from boundplanner_tpu.mpc.bound_mpc import mpc_tick  # noqa: E402
from boundplanner_tpu.parallel.batch import _plant_measurement  # noqa: E402
from boundplanner_tpu.parallel.fleet_cache import ensure  # noqa: E402
from boundplanner_tpu.utils.integration import integrate_jerk_step  # noqa: E402


def rollout_diag(carry, q0, obs, cfg, n_ticks):
    """closed_loop_rollout with a diagnostic record set."""
    zeros = jnp.zeros_like(q0)

    def step(state, _):
        carry, q, dq, ddq, jerk, qf = state
        meas = _plant_measurement(q, dq, ddq, jerk, qf, q0.dtype)
        carry_new, out = mpc_tick(carry, meas, obs, cfg)
        u0 = out["dddq"][0]
        u1 = out["dddq"][1]
        q_n, dq_n, ddq_n = integrate_jerk_step(q, dq, ddq, u0, u1, cfg.dt)
        qf_n = out["q"][-1]
        rec = {
            "phi": out["phi"][1],
            "success": out["success"],
            "viol": out["viol"],
            "err_cnt": carry_new.error_count,
            "dq_max": jnp.max(jnp.abs(dq)),
            "cost": out["cost"],
            "sector": out["sector"],
        }
        return (carry_new, q_n, dq_n, ddq_n, u1, qf_n), rec

    state0 = (carry, q0, zeros, zeros, zeros, q0)
    state, recs = jax.lax.scan(step, state0, None, length=n_ticks)
    return state[0], recs


def main():
    ticks = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    top = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    cfg = perf_mpc_params()
    fleet = ensure(128, 7, cfg.nr_segs)
    cb = jax.device_put(fleet["carry"])
    ob = jax.device_put(fleet["obs"])
    qb = jax.device_put(jnp.asarray(fleet["q0"]))

    roll = jax.jit(
        lambda c, q, o: jax.vmap(
            lambda cc, qq, oo: rollout_diag(cc, qq, oo, cfg, ticks)
        )(c, q, o)
    )
    _, recs = roll(cb, qb, ob)
    recs = jax.tree.map(np.asarray, recs)

    viol = recs["viol"]          # (128, ticks)
    succ = recs["success"]
    worst = np.argsort(-viol.max(axis=1))[:top]
    np.savez("/tmp/replay_worst.npz", **recs)
    print(f"fleet 128 x {ticks}: success {succ.mean():.4f} "
          f"max_viol {viol.max():.4f} (saved /tmp/replay_worst.npz)")
    print(f"scenes with any failed tick: "
          f"{np.where(~succ.all(axis=1))[0].tolist()}")
    for s in worst:
        print(f"\n--- scene {s}: max_viol {viol[s].max():.4f} "
              f"fails {int((~succ[s]).sum())}/{ticks} ---")
        print(" tick  succ  err  viol        phi      dq_max   sector")
        for t in range(ticks):
            flag = "" if succ[s, t] else "  <-- FAIL"
            print(f"  {t:3d}   {int(succ[s,t])}   {recs['err_cnt'][s,t]:3d}"
                  f"  {viol[s,t]:9.4f}  {recs['phi'][s,t]:8.4f}"
                  f"  {recs['dq_max'][s,t]:8.4f}  {int(recs['sector'][s,t]):3d}{flag}")


if __name__ == "__main__":
    main()
