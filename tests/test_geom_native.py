"""Native geometry core vs numpy fallback (cddlib replacement)."""

import numpy as np
import pytest

from boundplanner_tpu import native_geom
from boundplanner_tpu.utils import sets as set_utils


def cube(h=1.0):
    a = np.vstack([np.eye(3), -np.eye(3)])
    b = h * np.ones(6)
    return a, b


def test_native_compiles():
    assert native_geom.available(), "g++ build of native/geom.cpp failed"


def test_vertices_cube():
    a, b = cube()
    v = native_geom.polytope_vertices(a, b)
    assert v.shape == (8, 3)
    v_sorted = np.array(sorted(map(tuple, np.round(v, 9))))
    expect = np.array(sorted(map(tuple, set_utils.box_vertices([-1, -1, -1], [1, 1, 1]))))
    np.testing.assert_allclose(v_sorted, expect, atol=1e-9)


def test_vertices_random_matches_numpy(rng):
    for _ in range(5):
        a = rng.normal(size=(10, 3))
        a /= np.linalg.norm(a, axis=1, keepdims=True)
        b = a @ (0.1 * rng.normal(size=3)) + rng.uniform(0.3, 1.0, 10)
        a = np.vstack([a, np.eye(3), -np.eye(3)])
        b = np.concatenate([b, 2 * np.ones(6)])
        v_nat = native_geom.polytope_vertices(a, b)
        # numpy fallback (bypass native dispatch)
        verts = []
        m = a.shape[0]
        for i in range(m):
            for j in range(i + 1, m):
                for k in range(j + 1, m):
                    mat = a[[i, j, k]]
                    if abs(np.linalg.det(mat)) < 1e-10:
                        continue
                    x = np.linalg.solve(mat, b[[i, j, k]])
                    if np.all(a @ x <= b + 1e-7):
                        if not any(np.linalg.norm(x - vv) < 1e-8 for vv in verts):
                            verts.append(x)
        assert v_nat.shape[0] == len(verts)
        v1 = np.array(sorted(map(tuple, np.round(v_nat, 6))))
        v2 = np.array(sorted(map(tuple, np.round(np.array(verts), 6))))
        np.testing.assert_allclose(v1, v2, atol=1e-5)


def test_reduce_ineqs_drops_redundant():
    a, b = cube()
    # add redundant rows: looser copies of the first face and a far plane
    a2 = np.vstack([a, [1.0, 0, 0], [0.5, 0.5, 0.0]])
    b2 = np.concatenate([b, [2.0], [5.0]])
    a_r, b_r = native_geom.reduce_ineqs(a2, b2)
    assert a_r.shape[0] == 6
    v = native_geom.polytope_vertices(a_r, b_r)
    assert v.shape[0] == 8


def test_reduce_ineqs_keeps_tight():
    a, b = cube()
    a_r, b_r = native_geom.reduce_ineqs(a, b)
    assert a_r.shape[0] == 6


def test_library_rebuilt_when_source_is_newer(tmp_path, monkeypatch):
    import os
    import shutil

    src = tmp_path / "geom.cpp"
    shutil.copy(native_geom._SRC, src)
    lib = tmp_path / "build" / "libbp_geom.so"
    monkeypatch.setattr(native_geom, "_SRC", src)
    monkeypatch.setattr(native_geom, "_LIB_PATH", lib)
    assert native_geom._stale()                 # nothing built yet
    assert native_geom._compile() and lib.exists()
    assert not native_geom._stale()
    t = lib.stat().st_mtime
    os.utime(src, (t + 10, t + 10))             # source edited after the build
    assert native_geom._stale()
