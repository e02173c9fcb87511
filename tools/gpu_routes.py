"""Time the candidate routes of the two formerly hand-written kernels on
the GPU, inside the fused closed-loop tick and alone, at batch 1 and 128.

- KKT factorization (`ops.linalg.kkt_inverse`): ``xla`` (batched
  Cholesky + triangular solve against the identity) vs ``loop`` (the
  masked column-loop Cholesky + row-loop inversion).
- segment-box projection (`ops.seg_proj`): ``ipm`` (the exact QP-IPM per
  problem, defined here) vs ``jnp`` (the bisection in plain jnp) vs
  ``triton`` (the same arithmetic as one Pallas kernel through Triton);
  ``routed`` is `seg_poly_closest`, the route the program uses.

This is the record of how the routes were chosen, not a way to run the
program on another route: for each measurement it patches the function
the solver or the set finder calls (``unittest.mock.patch``) and undoes
the patch afterwards. The random problems are `chip_smoke.py`'s.

Each variant rolls the committed 128-scene planner fleet (and its first
scene alone) for ``TICKS`` closed-loop ticks at `perf_mpc_params()`,
reporting ms per tick and the fleet quality of the same run. ``precision``
repeats the default routes under ``jax.default_matmul_precision("highest")``;
``trace`` profiles one rollout at batch 128 and at batch 1 and reduces it with
`tools/trace_attrib.py`. One JSON object per line goes to stdout and to
``gpu_routes.jsonl`` in ``$GPU_ROUTES_OUT`` (default ``results/`` in the
checkout).

Usage: python tools/gpu_routes.py [ops] [tick[=KKT/PROJ,...]] [precision] [trace]
(no argument: all four; ``tick`` alone runs ``TICK_VARIANTS``)
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import sys
import time
import traceback
from unittest import mock

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))
OUT = os.environ.get("GPU_ROUTES_OUT") or os.path.join(REPO, "results")
TICKS = 20


def emit(rec: dict) -> None:
    os.makedirs(OUT, exist_ok=True)
    line = json.dumps(rec)
    print(line, flush=True)
    with open(os.path.join(OUT, "gpu_routes.jsonl"), "a") as f:
        f.write(line + "\n")


def ipm_closest(a, b, p0, p1):
    """Candidate (a): one 25-iteration QP-IPM per problem."""
    import jax

    from boundplanner_tpu.ops.qp import solve_line_projection

    return jax.vmap(lambda *v: solve_line_projection(*v, iters=25)[:2])(
        a, b, p0, p1)


def routes():
    from boundplanner_tpu.ops import linalg, seg_proj

    kkt = {"xla": linalg.kkt_inverse,
           "loop": lambda k: linalg.invert_lower(linalg.cholesky_masked(k))}
    proj = {"ipm": ipm_closest,
            "jnp": seg_proj.seg_poly_closest_jnp,
            "triton": seg_proj.seg_poly_closest_triton,
            "routed": seg_proj.seg_poly_closest}
    return kkt, proj


@contextlib.contextmanager
def use(kkt_name: str, proj_name: str):
    """Within the block, the solver and the planner/tick call the named
    candidates."""
    import jax

    from boundplanner_tpu.ops import qp
    from boundplanner_tpu.planner import set_finder

    kkt, proj = routes()
    jax.clear_caches()
    with mock.patch.object(qp, "kkt_inverse", kkt[kkt_name]), \
            mock.patch.object(set_finder, "seg_poly_closest", proj[proj_name]):
        yield
    jax.clear_caches()


def wall(fn, *args, reps=3):
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), ts


def fleet(batch: int):
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.config import perf_mpc_params
    from boundplanner_tpu.parallel import fleet_cache

    cfg = perf_mpc_params()
    f = fleet_cache.load(fleet_cache.cache_path(128, 7, cfg.nr_segs))
    take = lambda x: jnp.asarray(np.asarray(x)[:batch])  # noqa: E731
    return (cfg, jax.tree.map(take, f["carry"]),
            take(np.asarray(f["q0"], np.float32)), jax.tree.map(take, f["obs"]))


def rollout(batch: int, label: dict, precision=None):
    import jax

    from boundplanner_tpu.parallel.batch import executed_ee_penetration, fleet_rollout

    cfg, c, q, o = fleet(batch)

    def run(c, q, o):
        _, recs = fleet_rollout(c, q, o, cfg, TICKS)
        enter, dig_in = executed_ee_penetration(recs["p"], o)
        return recs, enter, dig_in

    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        t0 = time.perf_counter()
        compiled = jax.jit(run).lower(c, q, o).compile()
        t_compile = time.perf_counter() - t0
    med, ts = wall(compiled, c, q, o)
    recs, enter, dig_in = compiled(c, q, o)
    emit({**label, "batch": batch, "ticks": TICKS,
          "compile_s": t_compile, "rollout_s": ts,
          "ms_per_tick": 1e3 * med / TICKS,
          "solves_per_s": batch * TICKS / med,
          "success_rate": float(np.mean(np.asarray(recs["success"], np.float32))),
          "max_viol": float(np.max(np.asarray(recs["viol"]))),
          "mean_phi_final": float(np.mean(np.asarray(recs["phi"])[:, -1])),
          "ee_enter_m": float(enter), "ee_dig_in_m": float(dig_in)})
    return compiled, (c, q, o)


def ops_alone():
    """Each candidate alone at the fused tick's widths."""
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs

    kkt, proj = routes()
    rng = np.random.default_rng(0)
    for batch in (1, 128):
        k = jnp.asarray(cs.random_spd(rng, batch, 136), jnp.float32)
        for name, fn in kkt.items():
            f = jax.jit(jax.vmap(fn))
            med, _ = wall(f, k, reps=10)
            emit({"part": "kkt_alone", "route": name, "batch": batch, "n": 136,
                  "ms": 1e3 * med})
    for scenes in (1, 128):
        n = scenes * 6 * 16
        a, b, p0, p1 = (jnp.asarray(v, jnp.float32)
                        for v in cs.near_projections(rng, n))
        ref = None
        for name, fn in proj.items():
            f = jax.jit(fn)
            x, phi = (np.asarray(v) for v in f(a, b, p0, p1))
            med, _ = wall(f, a, b, p0, p1, reps=10)
            p0n, p1n = np.asarray(p0), np.asarray(p1)
            dist = np.linalg.norm(x - (p0n + phi[:, None] * (p1n - p0n)), axis=1)
            ref = dist if ref is None else ref
            emit({"part": "proj_alone", "route": name, "scenes": scenes,
                  "problems": n, "ms": 1e3 * med,
                  "max_abs_dist_minus_ipm": float(np.abs(dist - ref).max()),
                  "max_violation": float(np.max(
                      np.einsum("brk,bk->br", np.asarray(a), x) - np.asarray(b)))})


TICK_VARIANTS = "xla/ipm,xla/jnp,xla/triton,loop/routed"


def tick(variants=TICK_VARIANTS):
    for kkt_name, proj_name in (v.split("/") for v in variants.split(",")):
        for batch in (128, 1):
            try:
                with use(kkt_name, proj_name):
                    rollout(batch, {"part": "tick", "kkt": kkt_name,
                                    "proj": proj_name})
            except Exception:  # keep measuring the other variants
                emit({"part": "tick", "kkt": kkt_name, "proj": proj_name,
                      "batch": batch, "error": traceback.format_exc()[-2000:]})


def precision(kkt_name="xla", proj_name="routed"):
    with use(kkt_name, proj_name):
        for prec in (None, "highest"):
            rollout(128, {"part": "precision", "precision": prec or "default",
                          "kkt": kkt_name, "proj": proj_name})


def trace(kkt_name="xla", proj_name="routed"):
    for batch in (128, 1):
        with use(kkt_name, proj_name):
            trace_one(batch, kkt_name, proj_name)


def trace_one(batch, kkt_name, proj_name):
    import jax

    import trace_attrib

    compiled, args = rollout(batch, {"part": "trace_warm", "kkt": kkt_name,
                                     "proj": proj_name})
    tdir = os.path.join(OUT, "trace")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(compiled(*args))
    r = trace_attrib.main([tdir, "--scopes=kkt_inverse,seg_poly_closest"])
    longest = trace_attrib.longest_events(trace_attrib.find_xplane(tdir), 8)
    shutil.rmtree(tdir)  # keep what comes back from a chip run small
    emit({"part": "trace", "batch": batch, "kkt": kkt_name, "proj": proj_name,
          "total_ms": r["total_ns"] / 1e6, "busy_ms": r["busy_ns"] / 1e6,
          "window_ms": r["window_ns"] / 1e6,
          "by_scope_ms": {k: v / 1e6 for k, v in r["by_scope"].items()},
          "top_kernels_ms": {k[:100]: v / 1e6 for k, v in sorted(
              r["by_name"].items(), key=lambda kv: -kv[1])[:12]},
          "longest_events": longest})


def main(argv):
    import jax

    from boundplanner_tpu import compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: platform {dev.platform!r}")
    import chip_smoke as cs

    compile_cache.enable()
    emit({"part": "device", "kind": dev.device_kind,
          "nvidia_smi": cs.gpu_query("0")})
    parts = {"ops": ops_alone, "tick": tick, "precision": precision,
             "trace": trace}
    for arg in argv or list(parts):
        name, _, spec = arg.partition("=")
        t0 = time.perf_counter()
        try:
            parts[name](*([spec] if spec else []))
        except Exception:
            emit({"part": name, "error": traceback.format_exc()[-3000:]})
        emit({"part": name, "done_s": time.perf_counter() - t0})


if __name__ == "__main__":
    main(sys.argv[1:])
