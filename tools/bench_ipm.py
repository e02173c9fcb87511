"""Microbench the batched SQP/IPM solve in isolation.

Builds the EXACT tick-0 solve inputs of the BENCH fleet (via
`build_tick_params`, vmapped over the 128 scenes) and times
`mpc.solver.solve_sqp` — the Ipopt-replacement hot path (3 SQP x 5 IPM
iterations at the perf config) — for arbitrary knob overrides, without
the rest of the tick (window advance, link sets, telemetry, switching).

Timing uses a dependency-chained `lax.scan` of `reps` solves (each
solve's x0 is perturbed by the previous solution so XLA can neither
parallelize nor elide them) plus a scalar fetch that waits for it.

Usage: python tools/bench_ipm.py [reps=20] [knob=value ...]
e.g.   python tools/bench_ipm.py 20 qp_iters=4 qp_gondzio=2
"""
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from boundplanner_tpu import compile_cache  # noqa: E402

compile_cache.enable()

from boundplanner_tpu.config import perf_mpc_params  # noqa: E402


def main():
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    overrides = {}
    for a in sys.argv[2:]:
        k, v = a.split("=")
        cur = getattr(perf_mpc_params(), k)
        overrides[k] = type(cur)(int(v) if v.lstrip("-").isdigit() else v)

    cfg = perf_mpc_params()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
        print(f"# overrides: {overrides}")

    from boundplanner_tpu.mpc import ocp
    from boundplanner_tpu.mpc.bound_mpc import build_tick_params
    from boundplanner_tpu.mpc.solver import solve_sqp
    from boundplanner_tpu.parallel.batch import _plant_measurement
    from boundplanner_tpu.parallel.fleet_cache import ensure

    fleet = ensure(128, 7, cfg.nr_segs)
    cb = fleet["carry"]
    ob = fleet["obs"]
    q0 = jnp.asarray(np.asarray(fleet["q0"]))
    dtype = q0.dtype
    batch = q0.shape[0]
    z7 = jnp.zeros_like(q0[0])

    @jax.jit
    def build_params(carry, q, obs):
        meas = _plant_measurement(q, z7, z7, z7, q, dtype)
        params, _, _, _ = build_tick_params(carry, meas, obs, cfg)
        return params

    params = jax.vmap(build_params)(cb, q0, ob)
    jax.block_until_ready(params["q0"])
    nx = ocp.n_vars(cfg.n)
    print(f"# batch {batch}, n_vars {nx}, sqp {cfg.sqp_iters} x qp "
          f"{cfg.qp_iters} (+{cfg.qp_gondzio} gondzio)")

    @jax.jit
    def chain(params):
        def step(x_acc, _):
            sol = jax.vmap(lambda p, x0: solve_sqp(x0, p, cfg))(
                params, 1e-6 * x_acc
            )
            return sol.x, sol.viol

        xs, viols = jax.lax.scan(
            step, jnp.zeros((batch, nx), dtype), None, length=reps
        )
        return xs, viols

    xs, viols = chain(params)
    _ = float(np.asarray(viols)[-1, 0])  # compile + warm
    t0 = time.perf_counter()
    xs, viols = chain(params)
    _ = float(np.asarray(viols)[-1, 0])
    wall = time.perf_counter() - t0
    qps = reps * batch / wall
    print(f"{qps:.1f} SQP solves/s  ({wall * 1e3 / reps:.2f} ms per "
          f"{batch}-batch solve)")


if __name__ == "__main__":
    main()
