"""Bisect the batch-context sensitivity.

The same scene can solve or diverge depending on which PROGRAM compiled
around it (batch-1 vmap vs batch-128 fleet; CPU mesh vs GPU). Lanes are
mathematically independent everywhere in the stack (the IPM freezes
converged/failed lanes with exact masked updates; no cross-lane
reduction touches the iterate), so any lane-value difference across
batch shapes must come from XLA tiling the SAME per-lane arithmetic
differently (different accumulation trees => different f32 rounding).

This tool pins the FIRST stage where lane values diverge, per batch
shape, on one scene:

  A. eval      — residual/constraint values at a fixed x
  B. jac       — structured Jacobians at the same x
  C. qp1       — one full SQP solve from the same warm start
  D. tick      — the full fused MPC tick
  E. hetero    — lane s of the REAL heterogeneous 128-fleet tick vs the
                 replicated-128 tick (content dependence: if lanes were
                 truly independent under a FIXED program, these agree
                 bitwise; any diff means neighbor VALUES leak in, which
                 would be a real bug, not tiling)

Usage: python tools/bisect_batch.py [scene=43] [batches=1,8,128]
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
from boundplanner_tpu.mpc import ocp, ocp_jac  # noqa: E402
from boundplanner_tpu.mpc.bound_mpc import build_tick_params, mpc_tick  # noqa: E402
from boundplanner_tpu.mpc.solver import solve_sqp  # noqa: E402
from boundplanner_tpu.parallel.batch import _plant_measurement  # noqa: E402
from boundplanner_tpu.parallel.fleet_cache import ensure  # noqa: E402


def rep(tree, b):
    return jax.tree.map(lambda x: jnp.broadcast_to(x[None], (b,) + x.shape), tree)


def maxdiff(a, b):
    return float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float64) - jnp.asarray(b, jnp.float64))))


def main():
    scene = int(sys.argv[1]) if len(sys.argv) > 1 else 43
    batches = (
        [int(x) for x in sys.argv[2].split(",")] if len(sys.argv) > 2 else [1, 8, 128]
    )
    cfg = perf_mpc_params()
    fleet = ensure(128, 7, cfg.nr_segs)
    pick = lambda x: jax.tree.map(lambda a: jnp.asarray(a)[scene], x)  # noqa: E731
    carry1 = pick(fleet["carry"])
    obs1 = pick(fleet["obs"])
    q01 = jnp.asarray(fleet["q0"][scene])
    dtype = q01.dtype

    def tick_lane0(b):
        """All stages for one replicated batch size; returns lane-0 values."""
        cb, ob = rep(carry1, b), rep(obs1, b)
        qb = jnp.broadcast_to(q01[None], (b, 7))

        @jax.jit
        def run(cb, qb, ob):
            z = jnp.zeros_like(qb)
            meas = jax.vmap(
                lambda q: _plant_measurement(q, z[0], z[0], z[0], q, dtype)
            )(qb)

            def one(c, m, o):
                params, _, _, _ = build_tick_params(c, m, o, cfg)
                params = {k: jnp.asarray(v) for k, v in params.items()}
                x0 = jnp.zeros(ocp.n_vars(cfg.n), dtype)
                r, g = ocp.evaluate(x0, params, cfg)
                out_jac = ocp_jac.evaluate_with_jac_structured(x0, params, cfg)
                sol = solve_sqp(x0, params, cfg)
                return {
                    "A_r": r, "A_g": g,
                    "A_aj": params["a_set_joints"],
                    "A_bj": params["b_set_joints"],
                    "B_jr": out_jac[2], "B_jg": out_jac[3],
                    "C_x": sol.x, "C_viol": sol.viol,
                }

            stage = jax.vmap(one)(cb, meas, ob)
            _, out = jax.vmap(lambda c, m, o: mpc_tick(c, m, o, cfg))(cb, meas, ob)
            stage["D_q"] = out["q"]
            stage["D_phi"] = out["phi"]
            return stage

        return jax.tree.map(lambda x: np.asarray(x[0]), run(cb, qb, ob))

    print(f"scene {scene}, batches {batches}, perf config "
          f"(qp_bf16={cfg.qp_bf16})")
    ref = tick_lane0(batches[0])
    results = {batches[0]: ref}
    for b in batches[1:]:
        cur = tick_lane0(b)
        results[b] = cur
        print(f"--- batch {batches[0]} vs {b} (lane 0, max |diff|) ---")
        for k in ["A_r", "A_g", "A_aj", "A_bj", "B_jr", "B_jg", "C_x",
                  "C_viol", "D_q", "D_phi"]:
            print(f"  {k:7s} {maxdiff(ref[k], cur[k]):.3e}")
        # attribute the A_g divergence to constraint blocks: per-step
        # layout is [15 set | 6 band | 90 link | 1 phi] x (n-1), then
        # terminal, bounds, slack (`ocp.evaluate`)
        dg = np.abs(ref["A_g"].astype(np.float64) - cur["A_g"].astype(np.float64))
        n = cfg.n
        per = 15 + 6 + 90 + 1
        steps = dg[: (n - 1) * per].reshape(n - 1, per)
        blocks = {
            "set(15)": steps[:, :15], "band(6)": steps[:, 15:21],
            "link(90)": steps[:, 21:111], "phi(1)": steps[:, 111:],
            "terminal": dg[(n - 1) * per : (n - 1) * per + 21],
            "bounds+slack": dg[(n - 1) * per + 21 :],
        }
        for name, blk in blocks.items():
            print(f"    g-block {name:12s} max {blk.max():.3e}  nz {int((blk > 0).sum())}")

    # E: heterogeneous fleet lane vs replicated lane (content dependence
    # under the SAME batch-128 program shape)
    b = 128
    cb = jax.tree.map(jnp.asarray, fleet["carry"])
    ob = jax.tree.map(jnp.asarray, fleet["obs"])
    qb = jnp.asarray(fleet["q0"])

    @jax.jit
    def hetero(cb, qb, ob):
        z = jnp.zeros_like(qb)
        meas = jax.vmap(
            lambda q: _plant_measurement(q, z[0], z[0], z[0], q, dtype)
        )(qb)

        def one(c, m, o):
            params, _, _, _ = build_tick_params(c, m, o, cfg)
            params = {k: jnp.asarray(v) for k, v in params.items()}
            x0 = jnp.zeros(ocp.n_vars(cfg.n), dtype)
            sol = solve_sqp(x0, params, cfg)
            return sol.x

        return jax.vmap(one)(cb, meas, ob)

    x_het = np.asarray(hetero(cb, qb, ob)[scene])
    if b in results:
        print(f"--- E: heterogeneous-128 lane {scene} vs replicated-128 lane 0 ---")
        print(f"  C_x     {float(np.max(np.abs(x_het - results[b]['C_x']))):.3e}")


if __name__ == "__main__":
    main()
