"""`chip_smoke.py` outside the card: it must refuse any backend but a GPU,
and its host-side checks must catch what they are there to catch."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        chip_smoke.check_device(jax.devices(), 1)


def test_script_fails_on_cpu_backend():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


def test_via_path_check_catches_outside_point():
    eye = np.eye(3)
    box = (np.vstack([eye, -eye]), np.ones(6))
    p_via = [np.zeros(3), np.full(3, 0.5)]
    chip_smoke._via_path_inside(p_via, [box])
    with pytest.raises(AssertionError, match="outside its set"):
        chip_smoke._via_path_inside([np.zeros(3), np.full(3, 1.5)], [box])


def test_tick_kkt_check_catches_route_breakdown():
    """An indefinite matrix: the library Cholesky gives NaN where the
    column loop clamps its pivot, so the strict check must fail and the
    reporting one pass."""
    kkt = np.stack([np.eye(8), np.diag([1.0] * 7 + [-1.0])]).astype(np.float32)
    chip_smoke.check_tick_kkt("test", kkt, strict=False)
    with pytest.raises(AssertionError, match="non-finite KKT factors"):
        chip_smoke.check_tick_kkt("test", kkt, strict=True)


def test_projection_check_passes_on_host_route(rng):
    chip_smoke.check_projections("test", *chip_smoke.near_projections(rng, 96))


def test_projection_check_catches_wrong_distance(rng, monkeypatch):
    """A projection that stops short of the box must fail the check."""
    from boundplanner_tpu.ops import seg_proj

    def short(a, b, p0, p1):
        x, phi = seg_proj.seg_poly_closest_jnp(a, b, p0, p1)
        return x, jnp.clip(phi + 0.05, 0.0, 1.0)

    monkeypatch.setattr(seg_proj, "seg_poly_closest", short)
    with pytest.raises(AssertionError, match="seg_poly_closest"):
        chip_smoke.check_projections("test", *chip_smoke.near_projections(rng, 96))


def test_next_tick_inputs_from_fleet():
    """Operands of the tick after the fleet's start state, two scenes:
    one projection problem per link and present obstacle, and symmetric
    finite KKT matrices of the OCP's width."""
    cfg, fleet = chip_smoke.load_fleet()
    take = lambda x: np.asarray(x)[:2]  # noqa: E731
    carry = jax.tree.map(take, fleet["carry"])
    obs = jax.tree.map(take, fleet["obs"])
    q = jnp.asarray(take(fleet["q0"]), jnp.float32)
    proj, kkts = chip_smoke.next_tick_inputs(cfg, carry, q, obs, (cfg.qp_iters,))
    n_prob = 6 * int(np.asarray(obs.mask).sum())
    assert [v.shape for v in proj] == [(n_prob, 15, 3), (n_prob, 15),
                                       (n_prob, 3), (n_prob, 3)]
    (kkt,) = (np.asarray(k) for k in kkts)
    assert kkt.shape == (2, 136, 136) and kkt.dtype == np.float32
    assert np.isfinite(kkt).all()
    np.testing.assert_allclose(kkt, np.swapaxes(kkt, 1, 2), rtol=1e-5,
                               atol=1e-5 * np.abs(kkt).max())


@pytest.mark.gpu
def test_kernels_on_gpu(gpu):
    chip_smoke.phase_kernels()


@pytest.mark.gpu
def test_planner_on_gpu(gpu):
    chip_smoke.phase_planner()
