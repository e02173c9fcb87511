"""MVIE solver tests vs analytic solutions and a scipy SLSQP oracle."""

import numpy as np
import pytest
import scipy.optimize as sopt

import jax
import jax.numpy as jnp

from boundplanner_tpu.ops.mvie import mvie, mvie_fixed_mid, mvie_fixed_r


def box_set(half=np.array([1.0, 2.0, 0.5]), center=np.zeros(3)):
    a = np.vstack([np.eye(3), -np.eye(3)])
    b = np.concatenate([center + half, -(center - half)])
    return a, b


def test_mvie_box():
    """MVIE of a box is the ellipsoid with the box half-extents as axes."""
    half = np.array([1.0, 2.0, 0.5])
    center = np.array([0.3, -0.2, 0.1])
    a, b = box_set(half, center)
    res = mvie(jnp.asarray(a), jnp.asarray(b))
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.center), center, atol=1e-3)
    np.testing.assert_allclose(
        np.sort(np.linalg.eigvalsh(np.asarray(res.shape))),
        np.sort(half**2),
        rtol=2e-3,
    )


def _bounded_instance(rng, m=10):
    """Random half-spaces + a workspace box (real sets always carry one)."""
    a = rng.normal(size=(m, 3))
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    x_int = 0.1 * rng.normal(size=3)
    b = a @ x_int + rng.uniform(0.2, 1.0, m)
    a = np.vstack([a, np.eye(3), -np.eye(3)])
    b = np.concatenate([b, 1.5 * np.ones(6)])
    return a, b


def test_mvie_containment():
    """The resulting ellipsoid must satisfy every half-space: ||L^T a|| + a^T d <= b."""
    rng = np.random.default_rng(3)
    for _ in range(5):
        a, b = _bounded_instance(rng)
        res = mvie(jnp.asarray(a), jnp.asarray(b))
        assert bool(res.ok)
        l_mat = np.asarray(res.gen)
        d = np.asarray(res.center)
        margins = b - a @ d - np.linalg.norm(a @ l_mat, axis=1)
        assert margins.min() > -1e-6


def scipy_mvie_logdet(a, b):
    """SLSQP oracle maximizing sum(log diag) over lower-tri L and d."""
    def unpack(x):
        l = np.zeros((3, 3))
        l[np.tril_indices(3)] = x[:6]
        return l, x[6:]

    def neg_obj(x):
        return -(np.log(x[0]) + np.log(x[2]) + np.log(x[5]))

    def cons(x):
        l, d = unpack(x)
        return b - a @ d - np.linalg.norm(a @ l, axis=1)

    x0 = np.zeros(9)
    x0[[0, 2, 5]] = 0.05
    res = sopt.minimize(
        neg_obj,
        x0,
        constraints=[{"type": "ineq", "fun": cons}],
        bounds=[(1e-6, None), (None, None), (1e-6, None), (None, None), (None, None), (1e-6, None)]
        + [(None, None)] * 3,
        method="SLSQP",
        options={"maxiter": 300, "ftol": 1e-12},
    )
    l, d = unpack(res.x)
    return l @ l.T, d


def test_mvie_vs_scipy():
    rng = np.random.default_rng(7)
    for _ in range(3):
        a, b = _bounded_instance(rng, m=8)
        res = mvie(jnp.asarray(a), jnp.asarray(b))
        s_ref, d_ref = scipy_mvie_logdet(a, b)
        # volumes (det of shape) should agree closely
        det_ours = np.linalg.det(np.asarray(res.shape))
        det_ref = np.linalg.det(s_ref)
        assert det_ours > 0.98 * det_ref  # at least as good up to tolerance
        np.testing.assert_allclose(np.asarray(res.center), d_ref, atol=5e-2)


def test_mvie_fixed_mid_box():
    half = np.array([1.0, 1.0, 1.0])
    a, b = box_set(half)
    center = np.array([0.5, 0.0, 0.0])  # off-center -> max radius 0.5 in x
    res = mvie_fixed_mid(jnp.asarray(a), jnp.asarray(b), jnp.asarray(center))
    assert bool(res.ok)
    eigs = np.sort(np.linalg.eigvalsh(np.asarray(res.shape)))
    np.testing.assert_allclose(np.sqrt(eigs[0]), 0.5, rtol=5e-3)
    margins = b - a @ center - np.linalg.norm(a @ np.asarray(res.gen), axis=1)
    assert margins.min() > -1e-6


def test_mvie_fixed_r():
    a, b = box_set(np.array([2.0, 1.0, 1.0]))
    r_mat = np.eye(3)
    res = mvie_fixed_r(
        jnp.asarray(a), jnp.asarray(b), jnp.zeros(3), jnp.asarray(r_mat), 1.5
    )
    assert bool(res.ok)
    l_mat = np.asarray(res.gen)
    assert l_mat[0, 0] >= 1.5 - 1e-5  # axis lower bound respected
    margins = b - np.linalg.norm(a @ l_mat, axis=1)
    assert margins.min() > -1e-6
    # free axes should fill the box
    np.testing.assert_allclose(l_mat[1, 1], 1.0, rtol=5e-3)
    np.testing.assert_allclose(l_mat[2, 2], 1.0, rtol=5e-3)


def test_mvie_vmap():
    a1, b1 = box_set(np.array([1.0, 1.0, 1.0]))
    a2, b2 = box_set(np.array([0.5, 2.0, 1.0]))
    a = jnp.asarray(np.stack([a1, a2]))
    b = jnp.asarray(np.stack([b1, b2]))
    d0 = jnp.zeros((2, 3))
    res = jax.jit(jax.vmap(lambda aa, bb, dd: mvie(aa, bb, dd)))(a, b, d0)
    assert bool(res.ok[0]) and bool(res.ok[1])
    np.testing.assert_allclose(
        np.sort(np.linalg.eigvalsh(np.asarray(res.shape[1]))),
        np.sort(np.array([0.5, 2.0, 1.0]) ** 2),
        rtol=5e-3,
    )


def test_mvie_infeasible_seed_not_ok():
    """A seed outside the polytope must return ok=False (the reference
    raises on its ellipsoid-containment invariant,
    `ConvexSetFinder.py:433-438`; here the jit-compatible analog is the
    ok flag)."""
    a = jnp.concatenate([jnp.eye(3), -jnp.eye(3)])
    b = jnp.full((6,), 0.5)
    outside = jnp.array([2.0, 0.0, 0.0])
    assert not bool(mvie(a, b, d0=outside).ok)
    assert not bool(mvie_fixed_mid(a, b, outside).ok)
    assert not bool(mvie_fixed_r(a, b, outside, jnp.eye(3), 0.01).ok)
    # feasible seeds still succeed
    inside = jnp.zeros(3)
    assert bool(mvie(a, b, d0=inside).ok)
    assert bool(mvie_fixed_mid(a, b, inside).ok)
