"""Offline finder for the hard-scene anchor pin (draw, fail_tick).

`tests/test_external_anchor.py::test_hard_scene_failing_tick_anchored`
pins a (draw, fail_tick) pair whose perf-budget solve fails (viol > 1e-4)
— the pin goes stale whenever a solver change shifts which marginal tick
misses the iteration budget. This is the finder that locates a fresh pin:
it sweeps 5-obstacle random draws (same rng scheme as the fleet builders:
scene rng ``seed + 1000*draw``, planner seed ``seed + draw``), rolls each
planned scene closed-loop in f64 under the perf iteration counts, and
prints every (draw, tick) whose solve fails.

Usage:  python tools/find_hard_tick.py [n_draws=16] [ticks=8] [seed=7]
        (CPU, x64 — takes ~1 min per draw)

Pick a (draw, tick) with viol ~1e-4..1e-2 and early tick (cheap replay),
then update the pin in test_external_anchor.py.
"""
import os
import sys

os.environ["JAX_ENABLE_X64"] = "1"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from boundplanner_tpu.config import MPCParams  # noqa: E402
from boundplanner_tpu.demo import DEMO_Q0  # noqa: E402
from boundplanner_tpu.mpc.bound_mpc import mpc_tick  # noqa: E402
from boundplanner_tpu.parallel.fleet import plan_scene, random_scene  # noqa: E402
from boundplanner_tpu.robot import kinematics as kin  # noqa: E402
from boundplanner_tpu.utils.integration import integrate_jerk_step  # noqa: E402


def main():
    n_draws = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    seed = int(sys.argv[3]) if len(sys.argv) > 3 else 7

    # perf iteration counts in f64 (x64 disables the bf16 knobs) — MUST
    # match the cfg of test_hard_scene_failing_tick_anchored
    cfg = MPCParams(sqp_iters=3, qp_iters=5, qp_gondzio=1,
                    line_search_steps=4, warm_shift=True,
                    struct_ocp=True, struct_chunked=False)
    tick_fn = jax.jit(lambda c, m, o: mpc_tick(c, m, o, cfg))

    hits = []
    for draw in range(1, n_draws + 1):
        rng = np.random.default_rng(seed + 1000 * draw)
        obstacles, goal = random_scene(rng, 5)
        planned = plan_scene(DEMO_Q0.copy(), goal, obstacles, seed + draw,
                             cfg, np.float64)
        if planned is None:
            print(f"draw {draw}: plan failed, skipping")
            continue
        carry, obs = jax.device_put(planned[0]), jax.device_put(planned[1])
        q, dq, ddq = DEMO_Q0.astype(np.float64), np.zeros(7), np.zeros(7)
        jerk, qf = np.zeros(7), DEMO_Q0.astype(np.float64)
        row = []
        for tick in range(ticks):
            pose = np.asarray(kin.fk_pose(jnp.asarray(q)))
            v0 = np.asarray(kin.jacobian_fk(jnp.asarray(q)) @ dq)
            meas = {k: jnp.asarray(v) for k, v in {
                "q0": q, "dq0": dq, "ddq0": ddq, "p0": pose, "v0": v0,
                "u0": jerk, "qf": qf,
            }.items()}
            carry, out = tick_fn(carry, meas, obs)
            ok, viol = bool(out["success"]), float(out["viol"])
            row.append("." if ok else "F")
            if not ok:
                hits.append((draw, tick, viol))
                print(f"  HIT draw={draw} tick={tick} viol={viol:.2e}")
            u0, u1 = np.asarray(out["dddq"][0]), np.asarray(out["dddq"][1])
            q, dq, ddq = (np.asarray(a) for a in integrate_jerk_step(
                jnp.asarray(q), jnp.asarray(dq), jnp.asarray(ddq),
                jnp.asarray(u0), jnp.asarray(u1), cfg.dt))
            jerk = u1
            qf = np.asarray(out["q"][-1])
        print(f"draw {draw:3d}: {''.join(row)}")

    if hits:
        d, t, v = hits[0]
        print(f"\nfirst pin candidate: draw={d}, fail_tick={t} (viol {v:.2e})")
    else:
        print("\nno failing ticks found — widen n_draws/ticks")


if __name__ == "__main__":
    main()
