"""End-to-end check that the planner and the closed-loop MPC run on a GPU.

    python chip_smoke.py          # one card: kernels, planner, mission, fleet
    python chip_smoke.py --four   # the fleet sharded over four cards vs one

Phases, in order; any failure ends the run with a non-zero exit code:

1. device   -- JAX must report a GPU (no CPU fallback); the card's name and
               power limit come from ``nvidia-smi`` in a child process.
2. kernels  -- the KKT factorization (`ops.linalg.kkt_inverse`) and the
               segment-box projection (`ops.seg_proj.seg_poly_closest`,
               the Triton kernel on the card) as compiled for the card, at
               the widths of the fused tick, against float64 references and
               the plain forms.
3. planner  -- `BoundPlanner.plan_convex_set_path` on the example scene.
4. mission  -- `examples/boundplanner_with_mpc_example.main`: plan, then the
               100 ms MPC loop until the path end is reached.
5. fleet    -- `chunked_rollout` of the committed 128-scene planner fleet at
               `perf_mpc_params()` for 20 ticks, with the quality bars;
               then the kernel checks again on operands of the tick after
               the last. `tools/fleet_cpu_ref.py` runs the same rollout on
               the CPU backend for comparison.

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLEET_TICKS = 20
FOUR_TICKS = 10
# tolerances of the kernel comparisons, float32 on the card vs float64:
# ||L^-1 L - I||_inf grows like n * eps_f32 * cond(L); the random test
# matrices have cond(L) < 10, so 136 * 6e-8 * 10 ~ 1e-4
KKT_TOL = 1e-4
# the projection bisects phi to 2^-24 and returns the exact box point of
# s(phi): against the exact IPM its distance errs by float32 rounding of
# metre-scale coordinates (~1e-7 m); 1e-5 m leaves a hundredfold margin
PROJ_DIST_TOL = 1e-5
# the box point is a float32 clip: rows hold it to rounding
PROJ_FEAS_TOL = 1e-6
# the Triton kernel runs the plain form's arithmetic through another
# compiler: distances agree to rounding (points may not, where a segment
# runs parallel to a face and every phi of an interval is closest)
PROJ_KERNEL_TOL = 1e-6


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_query(index: str | None) -> str:
    """``nvidia-smi`` name and power limit, run in a child that does not
    import JAX (the parent alone holds the card)."""
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    if index is not None:
        cmd.append(f"--id={index}")
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60,
                         check=True)
    return out.stdout.strip()


def check_device(devices, count: int):
    """The run must be on ``count`` GPUs: anything else is a failure."""
    platform = devices[0].platform
    if platform != "gpu":
        raise RuntimeError(f"no GPU: JAX reports platform {platform!r}")
    if len(devices) != count:
        raise RuntimeError(f"expected {count} GPU(s), JAX reports {len(devices)}")
    return {"platform": platform, "kind": devices[0].device_kind,
            "count": len(devices)}


def timed(fn, *args, reps: int = 5, warm: bool = True):
    """Median wall time of ``fn(*args)`` to completion, after one warm call
    unless ``warm`` is False."""
    import jax

    if warm:
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def random_spd(rng, batch: int, n: int) -> np.ndarray:
    a = rng.normal(size=(batch, n, n)) / np.sqrt(n)
    return a @ np.swapaxes(a, 1, 2) + np.eye(n)


def near_projections(rng, batch: int, rows: int = 15, rot=None):
    """Box obstacles (6 active rows, the rest zero padding as in
    `planner.set_finder.build_obstacle_arrays`) and segments whose start
    lies 0-0.8 m off a box face (some inside its slab, near edges and
    corners): half of them at less than 0.2 rad to that face, where
    alternating projections converge slowly, the rest in random
    directions; 0.05-1 m long. ``rot`` (3, 3) turns boxes and segments."""
    idx = np.arange(batch)
    a = np.zeros((batch, rows, 3))
    b = 10.0 * np.ones((batch, rows))
    center = rng.uniform(-0.5, 0.5, (batch, 3))
    half = rng.uniform(0.05, 0.3, (batch, 3))
    eye = np.eye(3)
    a[:, :6] = np.concatenate([eye, -eye])
    b[:, :6] = np.concatenate([center + half, -(center - half)], axis=1)
    axis = rng.integers(0, 3, batch)
    side = rng.choice([-1.0, 1.0], batch)
    p0 = center + rng.uniform(-1.0, 1.0, (batch, 3)) * (half + 0.3)
    p0[idx, axis] = center[idx, axis] + side * (
        half[idx, axis] + rng.uniform(0.0, 0.8, batch))
    tangent = rng.normal(size=(batch, 3))
    tangent[idx, axis] = 0.0
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    normal = np.zeros((batch, 3))
    normal[idx, axis] = side
    angle = rng.uniform(-0.2, 0.2, batch)[:, None]
    grazing = np.cos(angle) * tangent + np.sin(angle) * normal
    random = rng.normal(size=(batch, 3))
    random /= np.linalg.norm(random, axis=1, keepdims=True)
    direction = np.where((idx % 2 == 0)[:, None], grazing, random)
    p1 = p0 + rng.uniform(0.05, 1.0, batch)[:, None] * direction
    if rot is not None:
        a = a @ rot.T
        p0, p1 = p0 @ rot.T, p1 @ rot.T
    return a, b, p0, p1


def ipm_closest_f64(a, b, p0, p1):
    """Exact closest points in float64: one 25-iteration QP-IPM
    (`ops.qp.solve_line_projection`) per problem."""
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.ops.qp import solve_line_projection

    with jax.enable_x64(True):
        solve = jax.jit(jax.vmap(
            lambda *v: solve_line_projection(*v, iters=25)[:2]))
        x, phi = solve(*(jnp.asarray(v, jnp.float64) for v in (a, b, p0, p1)))
        return np.asarray(x), np.asarray(phi)


def check_projections(label: str, a, b, p0, p1) -> None:
    """The routed projection (the Triton kernel on the card) against the
    float64 IPM and the plain jnp form, on float32 operands."""
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.ops.seg_proj import seg_poly_closest, seg_poly_closest_jnp

    args32 = [jnp.asarray(v, jnp.float32) for v in (a, b, p0, p1)]
    a, b, p0, p1 = (np.asarray(v, np.float64) for v in args32)

    def dist(x, phi):
        x, phi = np.asarray(x, np.float64), np.asarray(phi, np.float64)
        return np.linalg.norm(x - (p0 + phi[:, None] * (p1 - p0)), axis=1)

    f = jax.jit(seg_poly_closest)
    x, phi = f(*args32)
    d = dist(x, phi)
    derr = np.abs(d - dist(*ipm_closest_f64(a, b, p0, p1))).max()
    kerr = np.abs(d - dist(*jax.jit(seg_poly_closest_jnp)(*args32))).max()
    feas = np.max(np.einsum("brk,bk->br", a, np.asarray(x, np.float64)) - b)
    log(f"{label}: seg_poly_closest {len(p0)} problems (distance up to "
        f"{d.max():.3f} m, {np.mean(d < 1e-6):.3f} touching): max |dist - "
        f"dist_f64_ipm| {derr:.3e} m (tol {PROJ_DIST_TOL:.0e}), max "
        f"violation {feas:.2e} (tol {PROJ_FEAS_TOL:.0e}), max |dist - "
        f"dist_plain_jnp| {kerr:.2e} (tol {PROJ_KERNEL_TOL:.0e}), "
        f"{1e3 * timed(f, *args32):.3f} ms")
    if not (derr <= PROJ_DIST_TOL and feas <= PROJ_FEAS_TOL
            and kerr <= PROJ_KERNEL_TOL):
        raise AssertionError(
            f"seg_poly_closest: dist {derr}, viol {feas}, kernel {kerr}")


def check_tick_kkt(label: str, kkt, strict: bool) -> None:
    """Factor KKT matrices of the tick's IPM with the program's route and
    with the column loop (which clamps its pivots). A factor that is not
    finite freezes its IPM (the finite guard of `ops.qp.solve_qp`); with
    ``strict`` the route may give no more of them than the loop. The
    residual ||L^-1 K L^-T - I||_inf (float64) shows each route's
    accuracy on the factors that are finite."""
    import jax

    from boundplanner_tpu.ops.linalg import cholesky_masked, invert_lower, kkt_inverse

    k64 = np.asarray(kkt, np.float64)
    eye = np.eye(k64.shape[-1])
    bad = {}
    for name, fn in (("kkt_inverse", kkt_inverse),
                     ("column loop", lambda m: invert_lower(cholesky_masked(m)))):
        li = np.asarray(jax.jit(jax.vmap(fn))(kkt), np.float64)
        finite = np.isfinite(li).all(axis=(1, 2))
        res = np.abs(li[finite] @ k64[finite] @ np.swapaxes(li[finite], 1, 2)
                     - eye).sum(axis=-1).max(axis=-1)
        bad[name] = int((~finite).sum())
        log(f"{label}: {name} on {len(k64)} tick KKT matrices (n="
            f"{k64.shape[-1]}, float32): {bad[name]} not finite; "
            f"||L^-1 K L^-T - I||_inf median {np.median(res):.2e} max "
            f"{res.max():.2e}")
    if strict and bad["kkt_inverse"] > bad["column loop"]:
        raise AssertionError(f"non-finite KKT factors: {bad}")


def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.ops.linalg import cholesky_masked, invert_lower, kkt_inverse

    rng = np.random.default_rng(0)
    n = 136
    for batch in (1, 128):
        k64 = random_spd(rng, batch, n)
        k = jnp.asarray(k64, jnp.float32)
        l64 = np.linalg.cholesky(k64)
        for name, fn in (("kkt_inverse", kkt_inverse),
                         ("column-loop reference",
                          lambda m: invert_lower(cholesky_masked(m)))):
            f = jax.jit(jax.vmap(fn))
            li = np.asarray(f(k), np.float64)
            err = np.abs(li @ l64 - np.eye(n)).sum(axis=-1).max()
            upper = np.abs(np.triu(li, 1)).max()
            log(f"kernels: {name} n={n} batch={batch}: ||L^-1 L - I||_inf "
                f"{err:.3e} (tol {KKT_TOL:.0e}), max |upper| {upper:.1e}, "
                f"{1e3 * timed(f, k):.3f} ms")
            if not (err <= KKT_TOL and upper == 0.0):
                raise AssertionError(f"{name}: error {err}, upper {upper}")

    # the fused tick's width: 6 link segments x 16 obstacles per scene
    for scenes in (1, 128):
        check_projections("kernels", *near_projections(rng, scenes * 6 * 16))


def next_tick_inputs(cfg, carry, q, obs, qp_iters):
    """Operands of the tick that follows a rollout's last, per scene, at
    the executed joint positions ``q`` and the rates each scene's last
    accepted plan predicts: the link segments' projection problems (6
    links x each present obstacle, as `mpc.prep.link_collision_sets` hands
    them to `find_set_line`) and, for each entry of ``qp_iters``, the float32 KKT
    matrix the first SQP iteration's IPM factors in iteration
    ``qp_iters`` (so ``cfg.qp_iters`` gives the tick's last one)."""
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.config import NUM_LINK_SETS
    from boundplanner_tpu.mpc import ocp, ocp_jac, ocp_struct
    from boundplanner_tpu.mpc.bound_mpc import build_tick_params
    from boundplanner_tpu.ops.qp import kkt_matrix, solve_qp
    from boundplanner_tpu.parallel.batch import _plant_measurement
    from boundplanner_tpu.robot import kinematics as kin

    struct = ocp_struct.build(cfg.n, cfg.dt, cfg.struct_chunked)
    chain = kin.chain_by_name(cfg.robot)
    m_run = struct.m_run

    def one(c, q, o):
        meas = _plant_measurement(q, c.prev_dq[1], c.prev_ddq[1], c.prev_u[1],
                                  c.prev_q[-1], q.dtype, cfg.robot)
        ends = [kin.fk_pos_col_all(meas[k], chain)[:NUM_LINK_SETS]
                for k in ("q0", "qf")]
        shape = (NUM_LINK_SETS,) + o.b.shape
        proj = (jnp.broadcast_to(o.a, shape + (3,)),
                jnp.broadcast_to(o.b - 0.001, shape),
                *(jnp.broadcast_to(e[:, None], shape[:2] + (3,)) for e in ends))
        params = build_tick_params(c, meas, o, cfg)[0]
        x0 = ocp.shift_warm_start(c.x_prev, cfg)
        r, g, jr, jg = ocp_jac.evaluate_with_jac_structured(x0, params, cfg)
        hess = 2.0 * struct.gram_r(jr) + 1e-4 * jnp.eye(jr.shape[1], dtype=jr.dtype)
        kkts = []
        for iters in qp_iters:
            sol = solve_qp(hess, 2.0 * jr.T @ r, jg, -g[:m_run],
                           iters=iters - 1, tol=1e-10, lowp=cfg.qp_bf16,
                           struct=struct, h_tail=-g[m_run:],
                           gondzio=cfg.qp_gondzio, lowp_rd=cfg.qp_bf16_rd)
            kkts.append(kkt_matrix(hess, jg, sol.z / sol.s, 1e-10,
                                   cfg.qp_bf16, struct))
        return proj, kkts

    proj, kkts = jax.jit(jax.vmap(one))(carry, q, obs)
    # problems of present obstacles only (padding slots hold no box)
    present = np.broadcast_to(np.asarray(obs.mask)[:, None],
                              proj[1].shape[:3]).reshape(-1)
    proj = [np.asarray(v).reshape((-1,) + v.shape[3:])[present] for v in proj]
    return proj, kkts


def _via_path_inside(p_via, sets_via, tol: float = 2e-3) -> None:
    assert len(p_via) >= 2 and len(sets_via) == len(p_via) - 1, (
        len(p_via), len(sets_via))
    for i, (a, b) in enumerate(sets_via):
        for p in (p_via[i], p_via[i + 1]):
            viol = float(np.max(np.asarray(a) @ np.asarray(p) - np.asarray(b)))
            assert viol < tol, f"via point of segment {i} outside its set: {viol}"


def phase_planner() -> None:
    from scipy.spatial.transform import Rotation as R

    from boundplanner_tpu.planner import BoundPlanner
    from boundplanner_tpu.robot.model import RobotModel
    from examples.boundplanner_with_mpc_example import GOAL_P, GOAL_R, start_q
    from examples.scene import WORKSPACE_MAX, WORKSPACE_MIN, example_obstacles

    q0 = start_q()
    pose, _, _ = RobotModel().forward_kinematics(q0, 0 * q0)
    p0 = np.asarray(pose[:3])
    r0 = R.from_rotvec(np.array(pose[3:])).as_matrix()
    planner = BoundPlanner(
        e_p_max=0.5, obstacles=example_obstacles(),
        workspace_max=WORKSPACE_MAX, workspace_min=WORKSPACE_MIN, seed=0,
    )
    t0 = time.perf_counter()
    p_via, _, _, sets_via = planner.plan_convex_set_path(p0, GOAL_P, r0, GOAL_R)
    dt = time.perf_counter() - t0
    _via_path_inside(p_via, sets_via)
    log(f"planner: {len(p_via)} via points, {len(sets_via)} sets, every via "
        f"inside its sets, {dt:.2f} s (compilation included)")


def phase_mission() -> None:
    import contextlib
    import io

    from examples.boundplanner_with_mpc_example import main

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        traj, p_via, node = main(max_ticks=200)
    wall = time.perf_counter() - t0
    mpc = node.mpc
    phi, phi_max = float(mpc.phi_current[0]), float(mpc.phi_max[0])
    ticks = len(traj)
    err = float(np.linalg.norm(traj[-1] - np.asarray(p_via[-1])))
    # the node's own loop time per control period (FK, MPC step, plant
    # integration) over the loop's ticks; the step that compiled ran
    # before the plan was handed over
    t_loop = 1e3 * np.array([r.t_loop for r in node.telemetry.ticks])[-ticks:]
    log(f"mission: {ticks} ticks to phi {phi:.4f} / phi_max {phi_max:.4f}, "
        f"final EE error {1e3 * err:.1f} mm, tick p50 "
        f"{np.percentile(t_loop, 50):.2f} ms p99 {np.percentile(t_loop, 99):.2f}"
        f" ms max {t_loop.max():.2f} ms vs the 100 ms period ({wall:.1f} s "
        "wall, compilation included)")
    assert phi >= phi_max - 0.001, ("mission did not reach the path end", phi, phi_max)


def load_fleet():
    from boundplanner_tpu.config import perf_mpc_params
    from boundplanner_tpu.parallel import fleet_cache

    cfg = perf_mpc_params()
    return cfg, fleet_cache.load(fleet_cache.cache_path(128, 7, cfg.nr_segs))


def bytes_per_device(tree) -> dict:
    """Bytes of ``tree``'s arrays held on each device, by device id."""
    import jax

    held: dict = {}
    for leaf in jax.tree.leaves(tree):
        for shard in leaf.addressable_shards:
            held[shard.device.id] = held.get(shard.device.id, 0) + shard.data.nbytes
    return dict(sorted(held.items()))


def fleet_rollout_on(device, cfg, fleet, chunk: int, reps: int):
    """`chunked_rollout` of the fleet for ``FLEET_TICKS`` ticks on one
    device: (final carry, records, diagnostics, the compiled program). The
    wall is the median of ``reps`` runs after the first, or the first run's
    when ``reps`` is 0."""
    import jax
    import jax.numpy as jnp

    from boundplanner_tpu.parallel.batch import chunked_rollout, executed_ee_penetration

    cb, ob, qb = jax.device_put(
        (fleet["carry"], fleet["obs"], jnp.asarray(fleet["q0"], jnp.float32)),
        device)

    def run(c, q, o):
        final, recs = chunked_rollout(c, q, o, cfg, FLEET_TICKS, chunk=chunk)
        enter, dig_in = executed_ee_penetration(recs["p"], o)
        return final, recs, enter, dig_in

    t0 = time.perf_counter()
    compiled = jax.jit(run).lower(cb, qb, ob).compile()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    final, recs, enter, dig_in = jax.block_until_ready(compiled(cb, qb, ob))
    wall = time.perf_counter() - t0
    if reps:
        wall = timed(compiled, cb, qb, ob, reps=reps, warm=False)
    batch = int(qb.shape[0])
    diag = {
        "solves_per_s": batch * FLEET_TICKS / wall,
        "success_rate": float(np.mean(np.asarray(recs["success"], np.float32))),
        "max_viol": float(np.max(np.asarray(recs["viol"]))),
        "mean_phi_final": float(np.mean(np.asarray(recs["phi"])[:, -1])),
        "ee_enter_m": float(enter),
        "ee_dig_in_m": float(dig_in),
    }
    log(f"fleet on {device.platform} ({device.device_kind}): {batch} scenes x "
        f"{FLEET_TICKS} ticks in chunks of {chunk}, compiled in "
        f"{t_compile:.1f} s, {diag['solves_per_s']:.1f} solves/s "
        f"({1e3 * wall:.1f} ms per rollout), success "
        f"{diag['success_rate']:.4f}, max attempted viol "
        f"{diag['max_viol']:.6f}, mean final phi {diag['mean_phi_final']:.4f}, "
        f"executed EE enter {diag['ee_enter_m']:.4f} m dig-in "
        f"{diag['ee_dig_in_m']:.4f} m")
    return final, recs, diag, compiled


def phase_fleet() -> None:
    import jax

    from boundplanner_tpu.parallel.batch import (DIG_IN_BAR_M, ENTER_BAR_M,
                                                 SUCCESS_BAR, check_fleet_bars)

    cfg, fleet = load_fleet()
    final, recs, diag, compiled = fleet_rollout_on(
        jax.devices()[0], cfg, fleet, chunk=128, reps=3)
    log(f"fleet: memory_analysis of the card's rollout: "
        f"{compiled.memory_analysis()}")
    log(f"fleet: bars on the card's run: success >= {SUCCESS_BAR}, enter <= "
        f"{ENTER_BAR_M} m, dig-in <= {DIG_IN_BAR_M} m")
    check_fleet_bars(diag)

    # the kernels again, on operands of the tick after the rollout's last
    proj, (kkt,) = next_tick_inputs(cfg, final, recs["q"][:, -1],
                                    fleet["obs"], (cfg.qp_iters,))
    check_projections("fleet", *proj)
    check_tick_kkt(f"fleet (IPM iteration {cfg.qp_iters})", kkt, strict=True)


def phase_four() -> None:
    from boundplanner_tpu.parallel.batch import check_fleet_bars
    from boundplanner_tpu.parallel.mesh import make_mesh, mesh_fleet_rollout

    cfg, fleet = load_fleet()
    for n_dev in (4, 1):
        t0 = time.perf_counter()
        phis, diag, inputs = mesh_fleet_rollout(
            fleet["carry"], fleet["q0"], fleet["obs"], cfg, FOUR_TICKS,
            make_mesh(n_dev))
        dt = time.perf_counter() - t0
        assert np.isfinite(phis).all()
        log(f"four: {phis.shape[0]} scenes x {FOUR_TICKS} ticks over {n_dev} "
            f"card(s) ({dt:.1f} s, compilation included): input bytes per "
            f"device {bytes_per_device(inputs)}; success "
            f"{diag['success_rate']:.4f}, max attempted viol "
            f"{diag['max_viol']:.6f}, mean final phi "
            f"{diag['mean_phi_final']:.4f}, executed EE enter "
            f"{diag['ee_enter_m']:.4f} m dig-in {diag['ee_dig_in_m']:.4f} m")
        check_fleet_bars(diag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="shard the fleet over four cards and compare with one")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1
    if not args.four:
        # one process, one card: hide the others before JAX starts
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = visible.split(",")[0] if visible else "0"
    sys.path.insert(0, REPO)

    import jax

    from boundplanner_tpu import compile_cache

    device = check_device(jax.devices(), count)
    log(f"device: {device}; compile cache {compile_cache.enable()}")
    log(gpu_query(None if args.four else os.environ["CUDA_VISIBLE_DEVICES"]))
    phases = [phase_four] if args.four else [
        phase_kernels, phase_planner, phase_mission, phase_fleet]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        log(f"{phase.__name__}: ok ({time.perf_counter() - t0:.1f} s)")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
