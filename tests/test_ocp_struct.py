"""Block-banded structured OCP path vs the dense path, in float64.

Checks, in increasing integration order:
1. `evaluate_with_jac_structured` values/Jacobians == `evaluate_with_jac`
   (runtime rows) and the static tail operators reproduce the dense
   bound/slack Jacobian block exactly.
2. The chunked causal Gram products equal their dense counterparts.
3. `solve_qp(struct=...)` returns the dense IPM's solution.
4. A full `mpc_tick` with struct_ocp=True matches the manual_jac tick.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from boundplanner_tpu.config import MPCParams
from boundplanner_tpu.demo import demo_scene
from boundplanner_tpu.mpc import ocp, ocp_jac, ocp_struct
from boundplanner_tpu.mpc.bound_mpc import build_tick_params


@pytest.fixture(scope="module")
def setup():
    cfg = MPCParams()
    carry, meas, obs, q0 = demo_scene(cfg, dtype=np.float64)
    params = jax.tree.map(jnp.asarray, build_tick_params(carry, meas, obs, cfg)[0])
    rng = np.random.default_rng(5)
    nx = ocp.n_vars(cfg.n)
    xs = [np.zeros(nx), rng.normal(size=nx) * 0.3]
    st = ocp_struct.build(cfg.n, cfg.dt)
    return cfg, params, xs, st


def test_structured_matches_dense(setup):
    cfg, params, xs, st = setup
    for x in xs:
        x = jnp.asarray(x)
        r0, g0, jr0, jg0 = ocp_jac.evaluate_with_jac(x, params, cfg)
        r1, g1, jr1, jg1 = ocp_jac.evaluate_with_jac_structured(x, params, cfg)
        np.testing.assert_allclose(np.asarray(r1), np.asarray(r0), atol=1e-12)
        np.testing.assert_allclose(np.asarray(g1), np.asarray(g0), atol=1e-12)
        np.testing.assert_allclose(np.asarray(jr1), np.asarray(jr0), atol=1e-9)
        np.testing.assert_allclose(
            np.asarray(jg1), np.asarray(jg0)[: st.m_run], atol=1e-9
        )


def test_tail_operators_match_dense_block(setup):
    cfg, params, xs, st = setup
    x = jnp.asarray(xs[1])
    _, _, _, jg0 = ocp_jac.evaluate_with_jac(x, params, cfg)
    g_tail = np.asarray(jg0)[st.m_run :]
    assert g_tail.shape[0] == st.m_tail
    rng = np.random.default_rng(7)
    v = rng.normal(size=st.nx)
    y = rng.normal(size=st.m_tail)
    w = rng.uniform(0.1, 2.0, size=st.m_tail)
    np.testing.assert_allclose(
        np.asarray(st.tail_apply(jnp.asarray(v))), g_tail @ v, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(st.tail_apply_t(jnp.asarray(y))), g_tail.T @ y, atol=1e-10
    )
    np.testing.assert_allclose(
        np.asarray(st.tail_gram(jnp.asarray(w))),
        g_tail.T @ (w[:, None] * g_tail),
        atol=1e-9,
    )


def test_chunked_grams_match_dense(setup):
    cfg, params, xs, st = setup
    x = jnp.asarray(xs[1])
    _, _, jr, jg_run = ocp_jac.evaluate_with_jac_structured(x, params, cfg)
    rng = np.random.default_rng(9)
    w = jnp.asarray(rng.uniform(0.1, 2.0, size=st.m_run))
    jg_np = np.asarray(jg_run)
    np.testing.assert_allclose(
        np.asarray(st.gram_g(jg_run, w, lowp=False)),
        jg_np.T @ (np.asarray(w)[:, None] * jg_np),
        atol=1e-9,
    )
    jr_np = np.asarray(jr)
    np.testing.assert_allclose(
        np.asarray(st.gram_r(jr)), jr_np.T @ jr_np, atol=1e-9
    )
    # the chunk-A column support must cover every nonzero of its rows
    rows_a = st.half * st.per_step_g
    mask = np.ones(st.nx, bool)
    mask[st.cols_a] = False
    assert np.abs(jg_np[:rows_a][:, mask]).max() == 0.0
    rows_ar = st.half * st.per_step_r
    assert np.abs(np.asarray(jr)[:rows_ar][:, mask]).max() == 0.0


def test_solve_qp_struct_matches_dense(setup):
    from boundplanner_tpu.ops.qp import solve_qp

    cfg, params, xs, st = setup
    x = jnp.asarray(xs[0])
    r, g, jr, jg_run = ocp_jac.evaluate_with_jac_structured(x, params, cfg)
    _, _, _, jg_full = ocp_jac.evaluate_with_jac(x, params, cfg)
    hess = 2.0 * jr.T @ jr + 1e-4 * jnp.eye(st.nx, dtype=x.dtype)
    grad = 2.0 * jr.T @ r
    sol0 = solve_qp(hess, grad, jg_full, -g, iters=20)
    sol1 = solve_qp(
        hess, grad, jg_run, -g[: st.m_run], iters=20,
        struct=st, h_tail=-g[st.m_run :],
    )
    np.testing.assert_allclose(np.asarray(sol1.x), np.asarray(sol0.x), atol=1e-6)
    assert bool(sol0.success) and bool(sol1.success)


def test_link_operators_match_dense_block(setup):
    """The factored link path reproduces the dense link-row block:
    values/Jacobians under the [dense | link | tail] permutation, the
    three operators, and the full QP solution."""
    from boundplanner_tpu.ops.qp import solve_qp

    cfg0, params, xs, st = setup
    cfg = dataclasses.replace(cfg0, struct_ocp=True, struct_chunked=False,
                              struct_link=True)
    x = jnp.asarray(xs[1])
    r0, g0, jr0, jg0 = ocp_jac.evaluate_with_jac(x, params, cfg0)
    r1, g1, jr1, jgd, acol_u = ocp_jac.evaluate_with_jac_structured(
        x, params, cfg
    )
    # permutation of the runtime rows: per-step [set+band], then phi rows,
    # then the terminal block (evaluate order interleaves them per step)
    n = cfg.n
    ps = st.per_step_g
    perm = []
    for k in range(n - 1):
        perm += list(range(k * ps, k * ps + 21))
    perm += [k * ps + 111 for k in range(n - 1)]
    perm += list(range((n - 1) * ps, (n - 1) * ps + st.n_term_g))
    link_perm = []
    for k in range(n - 1):
        link_perm += list(range(k * ps + 21, k * ps + 111))
    full_perm = (
        perm + link_perm + list(range(st.m_run, st.m_run + st.m_tail))
    )
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r0), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(g1), np.asarray(g0)[full_perm], atol=1e-12
    )
    np.testing.assert_allclose(np.asarray(jr1), np.asarray(jr0), atol=1e-9)
    np.testing.assert_allclose(
        np.asarray(jgd), np.asarray(jg0)[perm], atol=1e-9
    )
    # operators vs the dense link block
    j_link = np.asarray(jg0)[link_perm]
    rng = np.random.default_rng(13)
    v = rng.normal(size=st.nx)
    y = rng.normal(size=st.m_link)
    w = rng.uniform(0.1, 2.0, size=st.m_link)
    aj = params["a_set_joints"]
    np.testing.assert_allclose(
        np.asarray(st.link_apply(acol_u, aj, jnp.asarray(v))),
        j_link @ v, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(st.link_apply_t(acol_u, aj, jnp.asarray(y))),
        j_link.T @ y, atol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(st.link_gram(acol_u, aj, jnp.asarray(w))),
        j_link.T @ (w[:, None] * j_link), atol=1e-8,
    )
    # full QP solution equality — the link path carries only the m_dense
    # runtime rows, so it must use a chunked=False struct (the solver-side
    # invariant enforced in `mpc/solver.py`; `gram_g` rejects partial-row
    # matrices under chunked=True)
    st_flat = ocp_struct.build(cfg.n, cfg.dt, chunked=False)
    hess = 2.0 * jr1.T @ jr1 + 1e-4 * jnp.eye(st.nx, dtype=x.dtype)
    grad = 2.0 * jr1.T @ r1
    sol0 = solve_qp(hess, grad, jg0, -g0, iters=20)
    md, ml = st.m_dense, st.m_link
    sol1 = solve_qp(hess, grad, jgd, -g1[:md], iters=20, struct=st_flat,
                    h_tail=-g1[md + ml:], link=(acol_u, aj),
                    h_link=-g1[md : md + ml])
    # row reordering changes the IPM's iterate path; solutions agree to
    # solver tolerance, not bitwise
    np.testing.assert_allclose(np.asarray(sol1.x), np.asarray(sol0.x),
                               atol=1e-5)
    assert bool(sol0.success) and bool(sol1.success)


def test_chunked_gram_rejects_partial_rows(setup):
    """A chunked-struct Gram over a partial-row matrix (e.g. the
    struct_link dense-row subset) must raise, not silently clip rows —
    the wrong-Gram path."""
    cfg, params, xs, st = setup
    assert st.chunked
    x = jnp.asarray(xs[1])
    cfg_l = dataclasses.replace(cfg, struct_ocp=True, struct_chunked=False,
                                struct_link=True)
    _, _, _, jgd, _ = ocp_jac.evaluate_with_jac_structured(x, params, cfg_l)
    assert jgd.shape[0] == st.m_dense != st.m_run
    w = jnp.ones(st.m_dense)
    with pytest.raises(ValueError, match="m_run"):
        st.gram_g(jgd, w)
    with pytest.raises(ValueError, match="m_r"):
        st.gram_r(jgd)


def test_struct_link_chunked_config_rejected():
    """struct_link + struct_chunked must raise (not assert) so the
    invariant survives `python -O`."""
    import jax.numpy as jnp

    from boundplanner_tpu.mpc.bound_mpc import mpc_tick

    cfg = MPCParams(struct_ocp=True, struct_chunked=True, struct_link=True)
    carry, meas, obs, q0 = demo_scene(cfg, dtype=np.float64)
    with pytest.raises(ValueError, match="struct_link"):
        mpc_tick(carry, meas, obs, cfg)


def test_tick_struct_link_matches(setup):
    from boundplanner_tpu.mpc.bound_mpc import mpc_tick

    cfg = MPCParams(sqp_iters=4, qp_iters=10, line_search_steps=4,
                    struct_ocp=True, struct_chunked=False)
    cfg_l = dataclasses.replace(cfg, struct_link=True)
    carry, meas, obs, q0 = demo_scene(cfg, dtype=np.float64)
    _, out0 = mpc_tick(carry, meas, obs, cfg)
    _, out1 = mpc_tick(carry, meas, obs, cfg_l)
    np.testing.assert_allclose(
        np.asarray(out1["q"]), np.asarray(out0["q"]), atol=1e-9
    )


def test_tick_struct_matches_manual(setup):
    from boundplanner_tpu.mpc.bound_mpc import mpc_tick

    cfg = MPCParams(sqp_iters=4, qp_iters=10, line_search_steps=4,
                    manual_jac=True)
    cfg_s = dataclasses.replace(cfg, manual_jac=False, struct_ocp=True)
    carry, meas, obs, q0 = demo_scene(cfg, dtype=np.float64)
    _, out0 = mpc_tick(carry, meas, obs, cfg)
    _, out1 = mpc_tick(carry, meas, obs, cfg_s)
    np.testing.assert_allclose(
        np.asarray(out1["q"]), np.asarray(out0["q"]), atol=1e-9
    )
    np.testing.assert_allclose(float(out1["cost"]), float(out0["cost"]), rtol=1e-9)
