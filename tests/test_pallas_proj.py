"""Segment-box closest points: both forms of the bisection vs the exact
IPM and a brute-force numpy witness, and the choice of form.

The Triton kernel runs in interpreter mode here; its compiled form is
compared with the same references by `chip_smoke.py` on the GPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from boundplanner_tpu.ops import seg_proj
from boundplanner_tpu.ops.qp import solve_line_projection

FORMS = {
    "jnp": seg_proj.seg_poly_closest_jnp,
    "triton_interpret": lambda *a: seg_proj.seg_poly_closest_triton(
        *a, interpret=True),
}


def make_batch(rng, bsz=24, r_rows=15):
    a = np.zeros((bsz, r_rows, 3))
    b = 10.0 * np.ones((bsz, r_rows))
    p0 = np.zeros((bsz, 3))
    p1 = np.zeros((bsz, 3))
    for i in range(bsz):
        center = rng.uniform(-0.5, 0.5, 3)
        half = rng.uniform(0.1, 0.3, 3)
        eye = np.eye(3)
        a[i, :6] = np.vstack([eye, -eye])
        b[i, :6] = np.concatenate([center + half, -(center - half)])
        # random segment outside-ish
        p0[i] = center + rng.uniform(0.5, 1.0, 3) * rng.choice([-1, 1], 3)
        p1[i] = p0[i] + rng.uniform(-0.5, 0.5, 3)
    return a, b, p0, p1


def make_near_batch(rng, bsz=48, r_rows=15, rot=None):
    """Segments whose start lies 0-0.8 m off a box face (some inside its
    slab, near edges and corners), half of them at less than 0.2 rad to
    that face, the rest in random directions, 0.05-1 m long. ``rot``
    (3, 3) turns every box and segment about the origin."""
    idx = np.arange(bsz)
    a = np.zeros((bsz, r_rows, 3))
    b = 10.0 * np.ones((bsz, r_rows))
    center = rng.uniform(-0.5, 0.5, (bsz, 3))
    half = rng.uniform(0.05, 0.3, (bsz, 3))
    eye = np.eye(3)
    a[:, :6] = np.concatenate([eye, -eye])
    b[:, :6] = np.concatenate([center + half, -(center - half)], axis=1)
    axis = rng.integers(0, 3, bsz)
    side = rng.choice([-1.0, 1.0], bsz)
    p0 = center + rng.uniform(-1.0, 1.0, (bsz, 3)) * (half + 0.3)
    p0[idx, axis] = center[idx, axis] + side * (
        half[idx, axis] + rng.uniform(0.0, 0.8, bsz))
    tangent = rng.normal(size=(bsz, 3))
    tangent[idx, axis] = 0.0
    tangent /= np.linalg.norm(tangent, axis=1, keepdims=True)
    normal = np.zeros((bsz, 3))
    normal[idx, axis] = side
    angle = rng.uniform(-0.2, 0.2, bsz)[:, None]
    grazing = np.cos(angle) * tangent + np.sin(angle) * normal
    random = rng.normal(size=(bsz, 3))
    random /= np.linalg.norm(random, axis=1, keepdims=True)
    direction = np.where((idx % 2 == 0)[:, None], grazing, random)
    p1 = p0 + rng.uniform(0.05, 1.0, bsz)[:, None] * direction
    if rot is not None:
        a = a @ rot.T
        p0, p1 = p0 @ rot.T, p1 @ rot.T
    return a, b, p0, p1


def brute_force_dist(a, b, p0, p1, samples=20001):
    """Distance from each segment to its box by a dense grid over the
    segment, with the box projection as a numpy clip in the box frame
    (rows 0-2 are the frame's axes, rows 3-5 their opposites)."""
    phis = np.linspace(0.0, 1.0, samples)[:, None]
    out = np.empty(len(p0))
    for i in range(len(p0)):
        frame = a[i, :3]
        s = (p0[i] + phis * (p1[i] - p0[i])) @ frame.T
        out[i] = np.linalg.norm(s - np.clip(s, -b[i, 3:6], b[i, :3]),
                                axis=1).min()
    return out


def ipm_dist(a, b, p0, p1):
    """Distances of the exact float64 QP-IPM, one solve per problem."""
    solve = jax.jit(jax.vmap(lambda *v: solve_line_projection(*v, iters=25)[:2]))
    x, phi = solve(*(jnp.asarray(v, jnp.float64) for v in (a, b, p0, p1)))
    return _dist(x, phi, p0, p1)


def random_rotation(rng):
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.diag(r))


def _dist(x, phi, p0, p1):
    seg = p0 + np.asarray(phi)[:, None] * (p1 - p0)
    return np.linalg.norm(np.asarray(x) - seg, axis=1)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("rotated", [False, True])
def test_near_box_matches_ipm_and_brute_force(rng, form, rotated):
    """Segments close to a box and nearly parallel to a face, where
    alternating projections converge slowly: the bisection's distance
    agrees with the exact IPM and with the brute-force grid, and its
    point lies in the box. The grid over-estimates the distance by at
    most half a grid step times the segment length (< 3e-5 m); the
    bisection, by its final half step (2^-25 of a segment under 1 m)."""
    rot = random_rotation(rng) if rotated else None
    a, b, p0, p1 = make_near_batch(rng, rot=rot)
    x, phi = FORMS[form](*(jnp.asarray(v) for v in (a, b, p0, p1)))
    dist = _dist(x, phi, p0, p1)
    np.testing.assert_allclose(dist, ipm_dist(a, b, p0, p1), atol=1e-6)
    grid = brute_force_dist(a, b, p0, p1)
    assert np.all(dist <= grid + 3e-8) and np.all(grid - dist <= 3e-5)
    assert np.max(np.einsum("brk,bk->br", a, np.asarray(x)) - b) < 1e-9


def test_separating_plane_supports_box(rng):
    """`set_finder.find_set_line` cuts each obstacle off with the plane
    through ``x`` with normal ``x - s(phi)``: every box corner lies on
    its far side and the whole segment on its near side."""
    a, b, p0, p1 = make_near_batch(rng, bsz=64)
    x, phi = (np.asarray(v) for v in seg_proj.seg_poly_closest_jnp(
        *(jnp.asarray(v) for v in (a, b, p0, p1))))
    seg_pt = p0 + phi[:, None] * (p1 - p0)
    n = x - seg_pt
    apart = np.linalg.norm(n, axis=1) > 1e-6
    level = np.einsum("bk,bk->b", n, x)
    signs = np.array(np.meshgrid([0, 1], [0, 1], [0, 1])).reshape(3, -1).T
    corners = np.where(signs[None], b[:, None, :3], -b[:, None, 3:6])
    far = np.einsum("bck,bk->bc", corners, n) - level[:, None]
    near = np.stack([np.einsum("bk,bk->b", p, n) for p in (p0, p1)], 1) - level[:, None]
    assert apart.sum() > 32
    assert np.all(far[apart] >= -1e-9)
    assert np.all(near[apart] <= 1e-9)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_matches_ipm(rng, form):
    a, b, p0, p1 = make_batch(rng)
    x, phi = FORMS[form](
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(p0), jnp.asarray(p1)
    )
    x = np.asarray(x)
    dist = _dist(x, phi, p0, p1)
    for i in range(a.shape[0]):
        x_ref, phi_ref, _ = solve_line_projection(
            jnp.asarray(a[i]), jnp.asarray(b[i]), jnp.asarray(p0[i]), jnp.asarray(p1[i])
        )
        seg_ref = p0[i] + float(phi_ref) * (p1[i] - p0[i])
        dist_ref = np.linalg.norm(np.asarray(x_ref) - seg_ref)
        # distances agree tightly; points agree to kernel tolerance
        np.testing.assert_allclose(dist[i], dist_ref, atol=2e-3)
        assert np.max(a[i] @ x[i] - b[i]) < 1e-4  # feasible


@pytest.mark.parametrize("form", sorted(FORMS))
def test_inside_segment(form):
    """Segment intersecting the polytope -> distance ~ 0."""
    eye = np.eye(3)
    a = np.vstack([eye, -eye])[None]
    b = np.ones((1, 6)) * 0.5
    p0 = np.array([[-1.0, 0.0, 0.0]])
    p1 = np.array([[1.0, 0.0, 0.0]])
    x, phi = FORMS[form](
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(p0), jnp.asarray(p1)
    )
    assert float(_dist(x, phi, p0, p1)[0]) < 1e-4


def test_triton_kernel_matches_jnp(rng):
    """The kernel runs the same arithmetic as the plain form: in interpret
    mode the two agree to rounding, across a batch that is not a multiple
    of the kernel's block (padding) and spans several programs."""
    a, b, p0, p1 = (jnp.asarray(v, jnp.float32)
                    for v in make_batch(rng, bsz=seg_proj.BLOCK + 9))
    x_k, phi_k = seg_proj.seg_poly_closest_triton(a, b, p0, p1, interpret=True)
    x_j, phi_j = seg_proj.seg_poly_closest_jnp(a, b, p0, p1)
    assert x_k.shape == (a.shape[0], 3) and phi_k.shape == (a.shape[0],)
    np.testing.assert_allclose(np.asarray(x_k), np.asarray(x_j), atol=1e-5)
    np.testing.assert_allclose(np.asarray(phi_k), np.asarray(phi_j), atol=1e-5)


def test_seg_poly_closest_folds_nested_vmaps(rng):
    """Nested (scene, link, obstacle) vmaps must agree with one flat
    batched call."""
    from boundplanner_tpu.ops.seg_proj import seg_poly_closest

    a, b, p0, p1 = make_batch(rng, bsz=12)
    a = jnp.asarray(a.reshape(2, 3, 2, 15, 3))
    b = jnp.asarray(b.reshape(2, 3, 2, 15))
    p0 = jnp.asarray(p0.reshape(2, 3, 2, 3))
    p1 = jnp.asarray(p1.reshape(2, 3, 2, 3))

    x_n, phi_n = jax.vmap(jax.vmap(seg_poly_closest))(a, b, p0, p1)
    assert x_n.shape == (2, 3, 2, 3) and phi_n.shape == (2, 3, 2)

    x_f, phi_f = seg_poly_closest(
        a.reshape(-1, 15, 3), b.reshape(-1, 15), p0.reshape(-1, 3),
        p1.reshape(-1, 3),
    )
    np.testing.assert_allclose(np.asarray(x_n).reshape(-1, 3), np.asarray(x_f),
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(phi_n).reshape(-1), np.asarray(phi_f),
                               atol=1e-12)


def test_seg_poly_closest_broadcasts_unbatched_operands(rng):
    """Outer vmap over scenes where the segment endpoints are shared
    (unbatched) must broadcast correctly."""
    from boundplanner_tpu.ops.seg_proj import seg_poly_closest

    a, b, p0, p1 = make_batch(rng, bsz=8)
    a = jnp.asarray(a.reshape(2, 4, 15, 3))
    b = jnp.asarray(b.reshape(2, 4, 15))
    p0s = jnp.asarray(p0[:4])
    p1s = jnp.asarray(p1[:4])

    x_v, phi_v = jax.vmap(lambda aa, bb: seg_poly_closest(aa, bb, p0s, p1s))(a, b)
    for i in range(2):
        x_d, phi_d = seg_poly_closest(a[i], b[i], p0s, p1s)
        np.testing.assert_allclose(np.asarray(x_v[i]), np.asarray(x_d), atol=1e-12)
        np.testing.assert_allclose(np.asarray(phi_v[i]), np.asarray(phi_d), atol=1e-12)


def test_route_is_plain_form_off_gpu(rng):
    """Lowered for the CPU, the routed function is the plain jnp form."""
    a, b, p0, p1 = (jnp.asarray(v, jnp.float32) for v in make_batch(rng, bsz=16))
    x_r, phi_r = jax.jit(seg_proj.seg_poly_closest)(a, b, p0, p1)
    x_j, phi_j = jax.jit(seg_proj.seg_poly_closest_jnp)(a, b, p0, p1)
    np.testing.assert_array_equal(np.asarray(x_r), np.asarray(x_j))
    np.testing.assert_array_equal(np.asarray(phi_r), np.asarray(phi_j))


@pytest.mark.parametrize("platform, kernel", [("cuda", True), ("cpu", False)])
def test_route_lowers_the_kernel_only_for_cuda(rng, platform, kernel):
    """Under the tick's nested vmaps, a CUDA lowering holds the Triton
    kernel and no loop of the plain form; a CPU lowering the reverse."""
    a, b, p0, p1 = (jnp.asarray(v.reshape((2, 3, 4) + v.shape[1:]), jnp.float32)
                    for v in make_batch(rng, bsz=24))
    f = jax.jit(jax.vmap(jax.vmap(seg_proj.seg_poly_closest)))
    text = f.trace(a, b, p0, p1).lower(lowering_platforms=(platform,)).as_text()
    assert ("xla.gpu.triton" in text) == kernel
    assert ("stablehlo.while" in text) != kernel
