"""Tests for the benchmark fleet cache (`parallel.fleet_cache`).

The cache is the bench's scene source: randomized planner-built fleets are
planned once on CPU and pickled; the GPU bench process only loads. These
tests cover the schema guard, the key layout, and (slow) a real 2-scene
build + reload round trip feeding the batched rollout.
"""

import os
import pickle

import numpy as np
import pytest

from boundplanner_tpu.parallel import fleet_cache


def test_cache_path_keys(tmp_path):
    p = fleet_cache.cache_path(128, 7, 4, root=str(tmp_path))
    assert p.endswith("fleet_b128_s7_segs4.pkl")
    assert str(tmp_path) in p


def test_load_rejects_wrong_schema(tmp_path):
    p = tmp_path / "bad.pkl"
    with open(p, "wb") as f:
        pickle.dump({"schema": "something_else"}, f)
    with pytest.raises(ValueError, match="schema"):
        fleet_cache.load(str(p))


@pytest.mark.slow
def test_build_and_reload_roundtrip(tmp_path):
    """Build a tiny real fleet, reload it, and run one batched tick."""
    import jax

    from boundplanner_tpu.config import default_mpc_params
    from boundplanner_tpu.parallel.batch import closed_loop_rollout

    # float64: the test env enables x64, where float32 pytrees would mix
    # with f64 scalars inside the solver loops
    path = str(tmp_path / "fleet2.pkl")
    payload = fleet_cache.build_and_save(2, 123, path, n_threads=2,
                                         dtype=np.float64)
    assert payload["broker_stats"]["calls_served"] > 0

    loaded = fleet_cache.load(path)
    assert loaded["batch"] == 2
    carry, q0, obs = loaded["carry"], loaded["q0"], loaded["obs"]
    assert q0.shape == (2, 7)

    cfg = default_mpc_params()
    final, recs = jax.jit(
        lambda c, q, o: jax.vmap(
            lambda cc, qq, oo: closed_loop_rollout(cc, qq, oo, cfg, 1)
        )(c, q, o)
    )(carry, q0, obs)
    assert np.isfinite(np.asarray(recs["phi"])).all()
