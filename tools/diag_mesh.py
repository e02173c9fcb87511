"""Per-scene diagnosis of a quality gap between backends.

Marginal scenes can track on one backend and fail on another (the
8-virtual-device CPU mesh sits near success 0.94 on the bench fleet). This tool runs
the dryrun's exact fleet on the CPU mesh at a chosen dtype and prints
per-scene failure sets, so flips can be classified:

- chaos (f32 rounding amplified): f32 and f64 fail DIFFERENT scene sets;
- systematic (backend semantics): the same scenes fail at both dtypes.

Usage: XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python tools/diag_mesh.py [f32|f64] [ticks=10] [knob=value ...]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
from boundplanner_tpu import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402


def main():
    dt_name = sys.argv[1] if len(sys.argv) > 1 else "f32"
    ticks = int(sys.argv[2]) if len(sys.argv) > 2 else 10
    if dt_name == "f64":
        jax.config.update("jax_enable_x64", True)
    dt = np.float64 if dt_name == "f64" else np.float32

    from boundplanner_tpu.config import perf_mpc_params
    from boundplanner_tpu.parallel import distributed as dist
    from boundplanner_tpu.parallel import fleet_cache
    from boundplanner_tpu.parallel.batch import fleet_rollout
    from boundplanner_tpu.parallel.mesh import make_mesh

    cfg = perf_mpc_params()
    if len(sys.argv) > 3:
        import dataclasses

        kv = {}
        for a in sys.argv[3:]:
            k, v = a.split("=")
            cur = getattr(cfg, k)
            kv[k] = type(cur)(int(v) if v.lstrip("-").isdigit() else v)
        cfg = dataclasses.replace(cfg, **kv)
        print(f"# overrides: {kv}")
    fleet = fleet_cache.load(fleet_cache.cache_path(128, 7, cfg.nr_segs))
    cast = lambda x: (  # noqa: E731
        np.asarray(x).astype(dt)
        if np.issubdtype(np.asarray(x).dtype, np.floating)
        else np.asarray(x)
    )
    carry_b = jax.tree.map(cast, fleet["carry"])
    obs_b = jax.tree.map(cast, fleet["obs"])
    q0_b = np.asarray(fleet["q0"]).astype(dt)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_dev)
    carry_b = dist.global_from_local(carry_b, mesh, 128)
    obs_b = dist.global_from_local(obs_b, mesh, 128)
    q0_b = dist.global_from_local(q0_b, mesh, 128)

    @jax.jit
    def run(carry, q0, obs):
        _, recs = fleet_rollout(carry, q0, obs, cfg, ticks)
        return recs["success"], recs["viol"], recs["phi"]

    succ, viol, phi = map(np.asarray, run(carry_b, q0_b, obs_b))
    fails = (succ < 0.5).sum(axis=1)
    bad = np.nonzero(fails)[0]
    print(f"mesh={n_dev}dev dtype={dt_name} ticks={ticks}: "
          f"success {succ.mean():.4f} max_viol {viol.max():.4f} "
          f"mean_phi {phi[:, -1].mean():.4f}")
    for s in bad:
        print(f"  scene {s:3d}: fails {int(fails[s])}/{ticks} "
              f"max_viol {viol[s].max():.4f} phi_final {phi[s, -1]:.3f}")


if __name__ == "__main__":
    main()
