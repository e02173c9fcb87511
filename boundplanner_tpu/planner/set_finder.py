"""Convex collision-free set construction — batched device kernels.

Batched re-design of the reference ``ConvexSetFinder``
(`bound_planner/BoundPlanner/ConvexSetFinder.py:102-510`). The reference
alternates native-solver calls (OSQP/qpOASES projections, CLARABEL MVIE)
with Python loops that mutate obstacle lists ("delete covered obstacles").
Here:

- obstacles live in fixed-shape padded arrays (H-rep rows + the 8 box
  corners + an active mask), so a whole scene is one pytree;
- all per-obstacle projections are solved in one batch: segment-box
  closest points by `ops.seg_proj`, ellipsoid-metric projections by a
  ``vmap`` of the dense QP-IPM (`ops.qp`);
- the sequential "closest obstacle -> separating half-space -> drop covered
  obstacles" loop becomes a fixed-trip-count masked ``scan``;
- the ellipsoid inflation loop calls the barrier-Newton MVIE (`ops.mvie`).

Deviation from the reference (documented): distances/half-spaces around a
grown ellipsoid use the true Mahalanobis metric of the ellipsoid
``{p + L u}`` (transform ``L``, gradient ``S^{-1}(x-p)``), where the
reference uses its ``q_ellipse = S^{-1}`` matrix as the transform
(`ConvexSetFinder.py:440,465-489`) — the IRIS-standard choice; behaviour is
equivalent (separating planes between the ellipsoid and obstacle closest
points), numerics slightly cleaner.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.qp import solve_qp
from ..ops.seg_proj import seg_poly_closest
from ..ops.mvie import mvie, mvie_fixed_mid
from ..utils.sets import box_vertices, make_box

MAX_OBS = 16
OBS_ROWS = 15


class ObstacleArrays(NamedTuple):
    a: jax.Array       # (M, OBS_ROWS, 3) H-rep rows (padded, inactive b=10)
    b: jax.Array       # (M, OBS_ROWS)
    points: jax.Array  # (M, 8, 3) box corners (of the size-increased box)
    mask: jax.Array    # (M,) bool — obstacle present


def build_obstacle_arrays(
    obstacles: Sequence[Sequence[float]],
    size_increase: float = 0.0,
    max_obs: int = MAX_OBS,
    dtype=np.float64,
) -> ObstacleArrays:
    """Host-side: AABB obstacles [xmin,ymin,zmin,xmax,ymax,zmax] ->
    padded arrays (ref `BoundPlanner.py:131-152` add_obstacle_reps; corner
    enumeration replaces cddlib, closed form for boxes)."""
    m = len(obstacles)
    if m > max_obs:
        raise ValueError(f"{m} obstacles exceed MAX_OBS={max_obs}")
    a_arr = np.zeros((max_obs, OBS_ROWS, 3), dtype=dtype)
    b_arr = 10.0 * np.ones((max_obs, OBS_ROWS), dtype=dtype)
    pts = np.zeros((max_obs, 8, 3), dtype=dtype)
    mask = np.zeros(max_obs, dtype=bool)
    for i, ob in enumerate(obstacles):
        lb, ub = np.asarray(ob[:3], dtype=dtype), np.asarray(ob[3:], dtype=dtype)
        a, b = make_box(lb, ub)
        a_arr[i, :6] = a
        b_arr[i, :6] = b + size_increase
        pts[i] = box_vertices(lb - size_increase, ub + size_increase)
        mask[i] = True
    # numpy leaves (transfer-only construction)
    return ObstacleArrays(a=a_arr, b=b_arr, points=pts, mask=mask)


def build_obstacle_arrays_np(obstacles, size_increase: float = 0.0,
                             max_obs: int = MAX_OBS, dtype=np.float64):
    return build_obstacle_arrays(obstacles, size_increase, max_obs, dtype)


def _init_rows_point(p, e_max, dtype):
    """Axis-aligned box of half-width e_max around p
    (ref `init_halfspaces_point`, `ConvexSetFinder.py:400-421`)."""
    eye = jnp.eye(3, dtype=dtype)
    a = jnp.concatenate([eye, -eye], axis=0)
    b = jnp.concatenate([p + e_max, -p + e_max])
    return a, b


def _init_rows_workspace(ws_min, ws_max, dtype):
    """Workspace box rows (ref `init_halfspaces`, `ConvexSetFinder.py:377-398`)."""
    eye = jnp.eye(3, dtype=dtype)
    a = jnp.concatenate([eye, -eye], axis=0)
    b = jnp.concatenate([ws_max, -ws_min])
    return a, b


def _halfspace_scan(
    obs: ObstacleArrays,
    obs_points,      # (M, 3) closest point of each obstacle (to seed object)
    anchor_points,   # (M, 3) the point the half-space separates from (per obs)
    dists,           # (M,) selection metric
    normal_fn,       # (x_closest, anchor) -> unnormalized half-space normal
    n_rows: int,
    b_margin: float,
    degenerate=None,  # (M,) bool — obstacle touches the seed object
):
    """Shared core of the reference's delete-covered-obstacles loops
    (`ConvexSetFinder.py:330-367,430-463`), as a fixed-length masked scan.

    Returns (a_rows (n_rows,3), b_rows (n_rows,), collision_flag)."""
    dtype = obs_points.dtype
    big = jnp.asarray(jnp.inf, dtype)
    if degenerate is None:
        degenerate = jnp.zeros(obs_points.shape[0], dtype=bool)

    def body(carry, _):
        active, collision = carry
        d = jnp.where(active, dists, big)
        idx = jnp.argmin(d)
        any_active = jnp.any(active)

        x = obs_points[idx]
        anchor = anchor_points[idx]
        a_raw = normal_fn(x, anchor)
        na = jnp.linalg.norm(a_raw)
        collision = collision | (any_active & degenerate[idx])
        a_unit = a_raw / jnp.maximum(na, 1e-12)
        b_val = jnp.dot(a_unit, x) - b_margin

        # drop every obstacle fully outside the new half-space
        corner_margin = (
            jnp.einsum("mkj,j->mk", obs.points, a_unit) - b_val
        )  # (M, 8)
        outside = jnp.min(corner_margin, axis=1) >= -1e-4
        new_active = active & ~outside
        new_active = new_active.at[idx].set(False)
        active = jnp.where(any_active, new_active, active)

        a_row = jnp.where(any_active, a_unit, jnp.zeros(3, dtype))
        b_row = jnp.where(any_active, b_val, jnp.asarray(10.0, dtype))
        return (active, collision), (a_row, b_row)

    (_, collision), (a_rows, b_rows) = jax.lax.scan(
        body, (obs.mask, jnp.asarray(False)), None, length=n_rows
    )
    return a_rows, b_rows, collision


@functools.partial(jax.jit, static_argnames=("n_rows", "limit_space"))
def find_set_line(
    p0,
    p1,
    obs: ObstacleArrays,
    e_max,
    ws_min,
    ws_max,
    limit_space: bool = True,
    n_rows: int = 15,
):
    """Collision-free convex set around the segment [p0, p1]
    (ref `find_set_collision_avoidance`, `ConvexSetFinder.py:309-375`).

    Returns (a (n_rows,3), b (n_rows,), collision flag). The first 6 rows
    are the init box, the rest separating half-spaces.
    """
    dtype = p0.dtype
    if limit_space:
        a_init, b_init = _init_rows_point(p0, e_max, dtype)
    else:
        a_init, b_init = _init_rows_workspace(ws_min, ws_max, dtype)

    # Closest obstacle point to the segment, per obstacle (batched;
    # ref `compute_set_projs_line`, `ConvexSetFinder.py:491-510`;
    # `ops.seg_proj`).
    m = obs.a.shape[0]
    xs, phis = seg_poly_closest(
        obs.a,
        obs.b - 0.001,
        jnp.broadcast_to(p0, (m, 3)),
        jnp.broadcast_to(p1, (m, 3)),
    )                                                     # (M,3), (M,)
    seg_pts = p0[None, :] + phis[:, None] * (p1 - p0)[None, :]
    dists = jnp.linalg.norm(xs - seg_pts, axis=1)

    def normal_fn(x, anchor):
        a_raw = x - anchor
        na = jnp.linalg.norm(a_raw)
        # degenerate fall-backs (ref `ConvexSetFinder.py:336-346`)
        a_alt = x - p0
        na_alt = jnp.linalg.norm(a_alt)
        a_alt2 = p1 - p0
        a_raw = jnp.where(na < 1e-6, jnp.where(na_alt < 1e-6, a_alt2, a_alt), a_raw)
        return a_raw

    a_rows, b_rows, collision = _halfspace_scan(
        obs, xs, seg_pts, dists, normal_fn, n_rows - 6, b_margin=0.001,
        degenerate=dists < 1e-6,
    )
    a_set = jnp.concatenate([a_init, a_rows], axis=0)
    b_set = jnp.concatenate([b_init, b_rows])
    return a_set, b_set, collision


def _polyhedron_once(p_seed, gen_l, shape_s, obs: ObstacleArrays, a_init, b_init, n_rows):
    """One separating-hyperplane sweep around the ellipsoid {p + L u}
    (ref `compute_polyhedron`, `ConvexSetFinder.py:423-463`)."""
    dtype = p_seed.dtype

    # per-obstacle closest point in the ellipsoid metric:
    # min |y|^2 s.t. (A L) y <= b - A p ; x = L y + p
    def proj_one(a_ob, b_ob):
        g = a_ob @ gen_l
        h = b_ob - a_ob @ p_seed
        sol = solve_qp(2.0 * jnp.eye(3, dtype=dtype), jnp.zeros(3, dtype), g, h, iters=25)
        y = sol.x
        return gen_l @ y + p_seed, jnp.linalg.norm(y)

    xs, dists = jax.vmap(proj_one)(obs.a, obs.b)

    s_inv = jnp.linalg.inv(shape_s + 1e-12 * jnp.eye(3, dtype=dtype))

    def normal_fn(x, anchor):
        return s_inv @ (x - anchor)

    anchors = jnp.broadcast_to(p_seed, xs.shape)
    a_rows, b_rows, _ = _halfspace_scan(
        obs, xs, anchors, dists, normal_fn, n_rows - 6, b_margin=0.0
    )
    ok = jnp.min(jnp.where(obs.mask, dists, jnp.inf)) > 0.99
    a_set = jnp.concatenate([a_init, a_rows], axis=0)
    b_set = jnp.concatenate([b_init, b_rows])
    return a_set, b_set, ok


@functools.partial(jax.jit, static_argnames=("n_rows", "max_iter"))
def find_set_around_line(
    p0,
    dp1,
    obs: ObstacleArrays,
    ws_min,
    ws_max,
    n_rows: int = 20,
    max_iter: int = 5,
):
    """Convex set grown around a line segment with the segment direction as
    a fixed ellipsoid axis (ref `find_set_around_line`,
    `ConvexSetFinder.py:242-307`): alternates separating-polytope sweeps
    with the fixed-orientation MVIE (`mvie_fixed_r`), keeping the first
    semi-axis long enough to cover the segment.

    Returns (a (n_rows,3), b (n_rows,), shape (3,3), center (3,), ok).
    """
    from ..ops.mvie import mvie_fixed_r
    from ..utils.so3 import gram_schmidt

    dtype = p0.dtype
    p1 = p0 + dp1
    l_seg = jnp.linalg.norm(dp1)
    dp_ref = dp1 / jnp.maximum(l_seg, 1e-12)
    p_seed = 0.5 * (p0 + p1)
    # axis lower bound (ref `:249`: a_lb = l_seg^2 / 4)
    a_lb = l_seg**2 / 4.0
    b1d = jnp.where(
        jnp.abs(dp_ref[2]) < 0.99,
        jnp.asarray([0.0, 0.0, 1.0], dtype),
        jnp.asarray([0.0, 1.0, 0.0], dtype),
    )
    b1 = gram_schmidt(dp_ref, b1d)
    b1 = b1 / jnp.maximum(jnp.linalg.norm(b1), 1e-12)
    b2 = jnp.cross(dp_ref, b1)
    b2 = b2 / jnp.maximum(jnp.linalg.norm(b2), 1e-12)
    r_ell = jnp.stack([dp_ref, b1, b2], axis=1)

    a_init, b_init = _init_rows_workspace(ws_min, ws_max, dtype)
    gen0 = r_ell @ jnp.diag(jnp.asarray([a_lb, 1e-2, 1e-2], dtype))

    def body(carry, _):
        p, gen, det_old, done = carry
        shape = gen @ gen.T
        a_set, b_set, _ = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
        res = mvie_fixed_r(a_set, b_set, p, r_ell, a_lb)
        det_new = jnp.abs(jnp.linalg.det(res.gen))
        degenerate = jnp.min(jnp.abs(jnp.diagonal(r_ell.T @ res.gen))) < 1e-3
        conv = jnp.abs(det_new - det_old) / jnp.maximum(det_old, 1e-12) < 0.01
        upd = ~done & res.ok & ~degenerate
        gen = jnp.where(upd, res.gen, gen)
        det_old = jnp.where(upd, det_new, det_old)
        done = done | conv | degenerate | ~res.ok
        return (p, gen, det_old, done), None

    carry = (p_seed, gen0, jnp.asarray(1e-12, dtype), jnp.asarray(False))
    (p, gen, _, _), _ = jax.lax.scan(body, carry, None, length=max_iter)
    shape = gen @ gen.T
    a_set, b_set, ok = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
    return a_set, b_set, shape, p, ok


@functools.partial(jax.jit, static_argnames=("fixed_mid", "n_rows", "max_iter"))
def find_set_around_point(
    p_seed,
    obs: ObstacleArrays,
    ws_min,
    ws_max,
    fixed_mid: bool = False,
    n_rows: int = 20,
    max_iter: int = 5,
):
    """IRIS-style alternation: separating polytope around an inflating
    ellipsoid + MVIE expansion (ref `find_set_around_point`,
    `ConvexSetFinder.py:190-240`).

    Returns (a (n_rows,3), b (n_rows,), shape S=LL^T (3,3), center (3,), ok).
    """
    dtype = p_seed.dtype
    a_init, b_init = _init_rows_workspace(ws_min, ws_max, dtype)

    gen0 = 1e-2 * jnp.eye(3, dtype=dtype)  # reference seeds S = 1e-4 I (`:192-194`)

    def body(carry, _):
        p, gen, det_old, done = carry
        shape = gen @ gen.T
        a_set, b_set, _ = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
        if fixed_mid:
            res = mvie_fixed_mid(a_set, b_set, p)
            p_new = p
        else:
            res = mvie(a_set, b_set, p)
            p_new = res.center
        det_new = jnp.abs(jnp.linalg.det(res.gen))
        degenerate = jnp.min(jnp.abs(jnp.diagonal(res.gen))) < 1e-3
        conv = jnp.abs(det_new - det_old) / jnp.maximum(det_old, 1e-12) < 0.01

        upd = ~done & res.ok & ~degenerate
        p = jnp.where(upd, p_new, p)
        gen = jnp.where(upd, res.gen, gen)
        det_old = jnp.where(upd, det_new, det_old)
        done = done | conv | degenerate | ~res.ok
        return (p, gen, det_old, done), None

    carry = (p_seed, gen0, jnp.asarray(1e-12, dtype), jnp.asarray(False))
    (p, gen, _, _), _ = jax.lax.scan(body, carry, None, length=max_iter)

    # final polytope at the converged ellipsoid; optional free-center polish
    # (ref `:235-238`)
    shape = gen @ gen.T
    a_set, b_set, ok = _polyhedron_once(p, gen, shape, obs, a_init, b_init, n_rows)
    if fixed_mid:
        res = mvie(a_set, b_set, p)
        keep = res.ok & (jnp.min(jnp.abs(jnp.diagonal(res.gen))) > 1e-4)
        gen = jnp.where(keep, res.gen, gen)
        p_out = jnp.where(keep, res.center, p)
        shape = gen @ gen.T
    else:
        p_out = p
    return a_set, b_set, shape, p_out, ok
