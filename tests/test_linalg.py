"""KKT factorization route and the masked-loop Cholesky vs numpy."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from boundplanner_tpu.ops.linalg import cholesky_masked, chol_solve, spd_solve


def random_spd(rng, n):
    a = rng.normal(size=(n, n))
    return a @ a.T + n * np.eye(n)


def test_cholesky_matches_numpy(rng):
    for n in (4, 17, 136):
        a = random_spd(rng, n)
        l = np.asarray(cholesky_masked(jnp.asarray(a)))
        l_ref = np.linalg.cholesky(a)
        np.testing.assert_allclose(l, l_ref, atol=1e-8 * n)


def test_solve(rng):
    for n in (4, 50):
        a = random_spd(rng, n)
        b = rng.normal(size=n)
        x = np.asarray(spd_solve(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_allclose(a @ x, b, atol=1e-8)


def test_vmap(rng):
    n, bsz = 24, 8
    a = np.stack([random_spd(rng, n) for _ in range(bsz)])
    b = rng.normal(size=(bsz, n))
    x = np.asarray(jax.vmap(spd_solve)(jnp.asarray(a), jnp.asarray(b)))
    for i in range(bsz):
        np.testing.assert_allclose(a[i] @ x[i], b[i], atol=1e-8)


def test_invert_lower(rng):
    from boundplanner_tpu.ops.linalg import invert_lower
    for n in (5, 40):
        a = random_spd(rng, n)
        l = np.linalg.cholesky(a)
        li = np.asarray(invert_lower(jnp.asarray(l)))
        np.testing.assert_allclose(li @ l, np.eye(n), atol=1e-9)


def _kkt_call(mode):
    """kkt_inverse unbatched, under one vmap, or under two nested vmaps."""
    from boundplanner_tpu.ops.linalg import kkt_inverse

    return {"unbatched": kkt_inverse,
            "vmap": jax.vmap(kkt_inverse),
            "nested_vmap": jax.vmap(jax.vmap(kkt_inverse))}[mode]


KKT_SHAPES = {"unbatched": (), "vmap": (3,), "nested_vmap": (2, 3)}
KKT_TOL = {"float32": (1e-4, 1e-4), "float64": (1e-10, 1e-9)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", sorted(KKT_SHAPES))
@pytest.mark.parametrize("n", [16, 40, 136])
def test_kkt_inverse_matches_numpy(rng, n, mode, dtype):
    """L^-1 from the chosen route: L^-1 L = I against numpy's factor,
    exactly lower-triangular, and K^-1 = L^-T L^-1."""
    lead = KKT_SHAPES[mode]
    ks = np.stack([random_spd(rng, n) for _ in range(int(np.prod(lead)))])
    ks = ks.reshape(lead + (n, n))
    li = np.asarray(jax.jit(_kkt_call(mode))(jnp.asarray(ks, dtype)))
    assert li.shape == ks.shape and li.dtype == np.dtype(dtype)
    tol_l, tol_k = KKT_TOL[dtype]
    for k, l_inv in zip(ks.reshape(-1, n, n), li.reshape(-1, n, n)):
        l_inv = l_inv.astype(np.float64)
        err = np.abs(l_inv @ np.linalg.cholesky(k) - np.eye(n)).max()
        assert err < tol_l, err
        assert np.abs(np.triu(l_inv, 1)).max() == 0.0
        k_inv = l_inv.T @ l_inv
        np.testing.assert_allclose(k_inv @ k, np.eye(n), atol=tol_k * n)


def test_kkt_inverse_matches_column_loop(rng):
    """The library route and the column-loop reference give the same
    inverse factor (float64)."""
    from boundplanner_tpu.ops.linalg import cholesky_masked, invert_lower, kkt_inverse

    ks = jnp.asarray(np.stack([random_spd(rng, 24) for _ in range(5)]))
    ref = np.asarray(jax.vmap(lambda k: invert_lower(cholesky_masked(k)))(ks))
    np.testing.assert_allclose(np.asarray(jax.vmap(kkt_inverse)(ks)), ref,
                               atol=1e-12)


def test_solve_qp_pallas_flag_equivalence(rng, monkeypatch):
    """The IPM gives the same solution whichever factorization route it
    runs (the library route vs the column-loop reference)."""
    from boundplanner_tpu.ops import linalg, qp

    n, m = 8, 16
    a = rng.normal(size=(n, n))
    p = a @ a.T + np.eye(n)
    q = rng.normal(size=n)
    g = rng.normal(size=(m, n))
    h = g @ (0.1 * rng.normal(size=n)) + rng.uniform(0.1, 1, m)
    args = [jnp.asarray(np.stack([v] * 3)) for v in (p, q, g, h)]
    solve = lambda *a: qp.solve_qp(*a).x  # noqa: E731
    x_lib = np.asarray(jax.vmap(solve)(*args))
    monkeypatch.setattr(
        qp, "kkt_inverse",
        lambda k: linalg.invert_lower(linalg.cholesky_masked(k)))
    jax.clear_caches()
    x_loop = np.asarray(jax.vmap(solve)(*args))
    jax.clear_caches()
    np.testing.assert_allclose(x_lib, x_loop, atol=1e-10)
