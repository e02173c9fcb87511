"""Batched segment-to-box closest points.

The per-obstacle line projection (`ConvexSetFinder.py:52-99,491-510`) is
the hottest small-geometry op of the engine: every MPC tick solves it for
6 links x 16 obstacles per scene, and the planner for every grown set.
Signature ``(a (B, R, 3), b (B, R), p0 (B, 3), p1 (B, 3)) -> (x (B, 3),
phi (B,))``: ``x`` is the point of the polytope ``{y : a y <= b}``
closest to the segment ``s(phi) = p0 + phi (p1 - p0)``, ``phi`` in [0, 1].

Method. ``f(phi) = |s(phi) - P(s(phi))|^2`` (``P`` the projection onto
the polytope) is convex in ``phi``, with derivative ``2 (s - P(s)) . d``,
so ``BISECT_ITERS`` bisection steps on the sign of that derivative pin
the minimizer to ``2^-BISECT_ITERS``. ``P`` subtracts each violated
row's half-space step, which is the exact projection when the rows are
pairwise orthogonal or opposite: a box in any orientation, which is
every obstacle here (`planner.set_finder.build_obstacle_arrays`; padding
rows have a zero normal and never act). The returned ``x`` is exactly
``P(s(phi))``, so the plane through ``x`` with normal ``x - s(phi)``
supports the box whatever the accuracy of ``phi``.

Element-wise arithmetic only, batch last (one vector per coordinate),
rows unrolled statically. Two forms of the same arithmetic:

- `seg_poly_closest_jnp`: plain ``jnp``, fused by XLA;
- `seg_poly_closest_triton`: one Pallas kernel through Triton, one block
  of ``BLOCK`` problems per program.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

BISECT_ITERS = 24  # float32 resolves phi to 2^-24
BLOCK = 128


def _dot(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _bisect_closest(a_rows, b_rows, p0, p1):
    """Closest pair between a segment and a box, on batch vectors.

    a_rows: R tuples of 3 arrays (L,); b_rows: R arrays (L,); p0, p1:
    tuples of 3 arrays (L,). Returns (x as 3 arrays, phi). Runs unchanged
    on ``jnp`` arrays and on the values inside a Pallas kernel.

    Each row's step ``t_r = max(a_r . s - b_r, 0) / |a_r|^2`` is taken
    from ``s`` itself: on a box a point violates at most one row of each
    opposite pair and the pairs are orthogonal, so the sequential sweep
    and this simultaneous form give the same point, ``s - sum_r t_r a_r``,
    and the derivative is ``2 sum_r t_r (a_r . d)``."""
    d = tuple(p1[k] - p0[k] for k in range(3))
    rows = []
    for a_r, b_r in zip(a_rows, b_rows):
        inv_n = 1.0 / jnp.maximum(_dot(a_r, a_r), 1e-12)
        # a_r . s(phi) - b_r = c + phi * e, scaled by 1 / |a_r|^2
        rows.append(((_dot(a_r, p0) - b_r) * inv_n, _dot(a_r, d) * inv_n,
                     _dot(a_r, d)))

    def step(_, bounds):
        lo, hi = bounds
        mid = 0.5 * (lo + hi)
        slope = sum(jnp.maximum(c + mid * e, 0.0) * ad for c, e, ad in rows)
        rising = slope >= 0.0
        return jnp.where(rising, lo, mid), jnp.where(rising, mid, hi)

    zero = jnp.zeros_like(d[0])
    lo, hi = jax.lax.fori_loop(0, BISECT_ITERS, step, (zero, zero + 1.0))
    phi = 0.5 * (lo + hi)
    x = tuple(p0[k] + phi * d[k] for k in range(3))
    for (c, e, _), a_r in zip(rows, a_rows):
        t = jnp.maximum(c + phi * e, 0.0)
        x = tuple(x[k] - t * a_r[k] for k in range(3))
    return x, phi


def seg_poly_closest_jnp(a, b, p0, p1):
    """Segment-box closest points in plain ``jnp`` (XLA fuses the steps)."""
    n_rows = a.shape[1]
    a_rows = [tuple(a[:, r, k] for k in range(3)) for r in range(n_rows)]
    b_rows = [b[:, r] for r in range(n_rows)]
    x, phi = _bisect_closest(
        a_rows, b_rows,
        tuple(p0[:, k] for k in range(3)), tuple(p1[:, k] for k in range(3)),
    )
    return jnp.stack(x, axis=-1), phi


def _triton_kernel(a_ref, b_ref, p_ref, out_ref, *, n_rows: int):
    """One program: BLOCK problems, one vector per coordinate.

    a_ref (3R, Bp), b_ref (R, Bp), p_ref (6, Bp) = p0 xyz | p1 xyz;
    out_ref (4, Bp) = x xyz | phi."""
    cols = pl.ds(pl.program_id(0) * BLOCK, BLOCK)
    row = lambda ref, i: pltriton.load(ref.at[np.int32(i), cols])  # noqa: E731
    a_rows = [tuple(row(a_ref, 3 * r + k) for k in range(3))
              for r in range(n_rows)]
    b_rows = [row(b_ref, r) for r in range(n_rows)]
    p0 = tuple(row(p_ref, k) for k in range(3))
    p1 = tuple(row(p_ref, 3 + k) for k in range(3))
    x, phi = _bisect_closest(a_rows, b_rows, p0, p1)
    for k in range(3):
        pltriton.store(out_ref.at[np.int32(k), cols], x[k])
    pltriton.store(out_ref.at[np.int32(3), cols], phi)


@functools.partial(jax.jit, static_argnames=("interpret",))
def seg_poly_closest_triton(a, b, p0, p1, interpret: bool = False):
    """Segment-box closest points as one Pallas kernel through Triton. The
    batch is padded to a multiple of ``BLOCK`` with harmless problems."""
    bsz, n_rows, _ = a.shape
    dtype = a.dtype
    pad = (-bsz) % BLOCK
    a_t = jnp.pad(jnp.transpose(a, (1, 2, 0)).reshape(3 * n_rows, bsz),
                  ((0, 0), (0, pad)))
    b_t = jnp.pad(b.T, ((0, 0), (0, pad)), constant_values=1.0)
    p_t = jnp.pad(jnp.concatenate([p0.T, p1.T]), ((0, 0), (0, pad)))
    btot = bsz + pad
    out = pl.pallas_call(
        functools.partial(_triton_kernel, n_rows=n_rows),
        out_shape=jax.ShapeDtypeStruct((4, btot), dtype),
        grid=(btot // BLOCK,),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="seg_poly_closest_bisect",
    )(a_t, b_t, p_t)
    return out[:3, :bsz].T, out[3, :bsz]


def seg_poly_closest(a, b, p0, p1):
    """The route the planner and the fused tick use: the Triton kernel
    where the program is lowered for a CUDA GPU, the plain ``jnp`` form of
    the same arithmetic everywhere else (CPU tests). Chosen by measurement
    inside the closed-loop tick on the H100 (PERF.md)."""
    with jax.named_scope("seg_poly_closest"):
        return jax.lax.platform_dependent(
            a, b, p0, p1,
            cuda=seg_poly_closest_triton,
            default=seg_poly_closest_jnp,
        )
