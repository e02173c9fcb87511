"""Arc-length-parameterized piecewise-linear pose reference path.

Fixed-shape re-design of the reference ``ReferencePath``
(`bound_planner/ReferencePath/ReferencePath.py:7-245`):

- Path construction (per-plan, host-side, numpy): via points -> per-segment
  direction vectors, rotation deltas as scaled rotation vectors,
  integrated-omega waypoints ``iw``, Gram-Schmidt orthonormal bases, segment
  lengths. All arrays are padded to a *fixed* maximum number of via points so
  that every downstream computation is shape-static (one XLA compilation
  serves every plan).

- The moving ``nr_segs`` window (`ReferencePath.py:173-231`) becomes pure
  gathers at ``sector + arange(nr_segs)``: the reference's incremental
  shift-and-refill ``update`` is equivalent to ``phi_switch[i] =
  cumsum(seg_len)[sector+i] + phi_bias`` and window slices of the base
  arrays, which is what we compute directly — no mutable state.

- The via-point snap-correction performed by the MPC switching logic
  (`BoundMPC/BoundMPC.py:992-1011`) updates the *base* arrays functionally;
  windows follow automatically.

``PathState`` is a pytree and can be carried through ``jit``/``scan``/``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from scipy.spatial.transform import Rotation as SciRotation

from ..config import MPC_SET_ROWS

MAX_VIAS = 16  # fixed via-point capacity (actual plans use ~2-8)


class PathState(NamedTuple):
    """Padded path data + window cursor. Leading axis MAX_VIAS everywhere."""

    p: jax.Array            # (V, 3)   via positions
    r: jax.Array            # (V, 3, 3) via rotations
    r_tau: jax.Array        # (V, 3)   via rotations as rotation vectors
    iw: jax.Array           # (V, 3)   integrated omega at via points
    dp: jax.Array           # (V, 3)   raw segment position deltas
    dp_unit: jax.Array      # (V, 3)   unit segment directions
    dr: jax.Array           # (V, 3)   segment omega scaled to d(rotvec)/d(phi)
    dr_normed: jax.Array    # (V, 3)   unit rotation axes (with sign-flip fix)
    seg_len: jax.Array      # (V,)     per-segment phi length ("phi" list)
    bp1: jax.Array          # (V, 3)   position-error basis 1
    bp2: jax.Array          # (V, 3)   position-error basis 2
    br1: jax.Array          # (V, 3)   rotation-error basis 1
    br2: jax.Array          # (V, 3)   rotation-error basis 2
    e_r_bound: jax.Array    # (V, 6)   orientation bound (upper 3 / lower 3)
    a_set: jax.Array        # (V, 15, 3) per-segment convex set
    b_set: jax.Array        # (V, 15)
    sector: jax.Array       # ()       int32 current sector
    num_sectors: jax.Array  # ()       int32 (= len(vias) - 2)
    phi_max: jax.Array      # ()
    phi_bias: jax.Array     # ()
    switched: jax.Array     # ()       bool — last update advanced the window

    @property
    def phi_cumsum(self):
        return jnp.cumsum(self.seg_len)


def _unit(v, fallback=None):
    n = np.linalg.norm(v)
    if n < 1e-12:
        return np.array(fallback) if fallback is not None else v
    return v / n


def build_path(
    p_via: Sequence[np.ndarray],
    r_via: Sequence[np.ndarray],
    bp1: Sequence[np.ndarray],
    br1: Sequence[np.ndarray],
    e_r_bound: Sequence[np.ndarray],
    a_sets: Sequence[np.ndarray],
    b_sets: Sequence[np.ndarray],
    nr_segs: int = 4,
    phi_bias: float = 0.0,
    dtype=np.float64,
    spiral_blend: float = 0.0,
    spiral_sub: int = 4,
) -> PathState:
    """Host-side path preprocessing (ref `ReferencePath.py:12-166`).

    ``spiral_blend > 0`` opts into euler-spiral corner blending with that
    half-arc length: interior corners are replaced by ``spiral_sub``
    sub-segments sampled on a clothoid (`euler_spiral.blend_corners`).
    Opt-in EXCEEDS the reference — its spiral module is bit-rotted and
    unwired (SURVEY.md §2.4)."""
    if spiral_blend > 0.0:
        from .euler_spiral import blend_corners

        (p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets) = blend_corners(
            p_via, r_via, bp1, br1, e_r_bound, a_sets, b_sets,
            length=spiral_blend, n_sub=spiral_sub,
        )
    p_list = [np.asarray(x, dtype=dtype) for x in p_via]
    r_list = [np.asarray(x, dtype=dtype) for x in r_via]
    l_traj = len(p_list)
    num_sectors = l_traj - 2
    if l_traj + nr_segs > MAX_VIAS:
        raise ValueError(f"path with {l_traj} vias exceeds MAX_VIAS={MAX_VIAS}")

    e_r_bound = [np.asarray(x, dtype=dtype) for x in e_r_bound]
    a_list = [np.asarray(x, dtype=dtype) for x in a_sets]
    b_list = [np.asarray(x, dtype=dtype) for x in b_sets]

    # --- rotation deltas, normed axes with direction-flip guard, iw ---
    dr, dr_normed, iw = [], [], [np.zeros(3, dtype=dtype)]
    omega_prev = np.array([0.0, 1.0, 0.0])
    for i in range(1, l_traj):
        drot = SciRotation.from_matrix(r_list[i] @ r_list[i - 1].T).as_rotvec()
        dr.append(drot)
        norm_dr = np.linalg.norm(drot)
        if norm_dr > 1e-4:
            axis = drot / norm_dr
            # do not change the projection axis when only reversing direction
            if np.linalg.norm(omega_prev + axis) < 1e-4:
                axis = -axis
            dr_normed.append(axis)
        else:
            dr_normed.append(omega_prev.copy())
        omega_prev = dr_normed[-1].copy()
        iw.append(iw[-1] + dr[-1])

    # --- position deltas with degenerate-segment fallback ---
    dp = []
    for i in range(1, l_traj):
        d = p_list[i] - p_list[i - 1]
        if np.linalg.norm(d) < 1e-3:
            d = dp[-1].copy() if i > 1 else np.array([0.0, 1.0, 0.0])
        dp.append(d)

    # --- segment lengths (rotation-only segments get |dr|/pi) ---
    seg_len = []
    for i in range(1, l_traj):
        li = np.linalg.norm(p_list[i] - p_list[i - 1])
        if li < 1e-3:
            li = np.linalg.norm(dr[i - 1]) / np.pi
        seg_len.append(li)
    phi_max = float(np.sum(seg_len)) + phi_bias

    # --- orthonormal bases ---
    bp1_l, bp2_l, br1_l, br2_l = [], [], [], []
    for i in range(l_traj - 1):
        dpu = _unit(dp[i])
        b1 = np.asarray(bp1[i], dtype=dtype)
        b1 = b1 - np.dot(dpu, b1) * dpu
        if np.linalg.norm(b1) < 1e-3:
            b1 = np.array([1.0, 1.0, 1.0])
            b1 = b1 - np.dot(dpu, b1) * dpu
        b1 = _unit(b1)
        bp1_l.append(b1)
        bp2_l.append(_unit(np.cross(dpu, b1)))

        b1r = np.asarray(br1[i], dtype=dtype)
        axis = dr_normed[i]
        b1r = b1r - np.dot(axis, b1r) * axis
        if np.linalg.norm(b1r) < 1e-3:
            b1r = np.array([1.0, 1.0, 1.0])
            b1r = b1r - np.dot(axis, b1r) * axis
        b1r = _unit(b1r)
        br1_l.append(b1r)
        br2_l.append(_unit(np.cross(axis, b1r)))

    # --- scale omega to phi parametrization (ref `ReferencePath.py:152-155`) ---
    dr_scaled = [
        dr[i] / seg_len[i] if seg_len[i] > 1e-8 else dr[i] for i in range(l_traj - 1)
    ]

    def pad(arrs, shape_tail):
        out = np.zeros((MAX_VIAS,) + shape_tail, dtype=dtype)
        for i, a in enumerate(arrs):
            out[i] = a
        for i in range(len(arrs), MAX_VIAS):
            out[i] = arrs[-1]
        return out

    # normalize set shapes to (15, 3)/(15,)
    a_norm, b_norm = [], []
    for a, b in zip(a_list, b_list):
        a_p = np.zeros((MPC_SET_ROWS, 3), dtype=dtype)
        b_p = 10.0 * np.ones(MPC_SET_ROWS, dtype=dtype)
        a_p[: a.shape[0]] = a
        b_p[: b.shape[0]] = b
        a_norm.append(a_p)
        b_norm.append(b_p)

    r_tau = [SciRotation.from_matrix(r).as_rotvec() for r in r_list]
    # seg_len list in the reference gets "1" padding entries
    # (`ReferencePath.py:104-105`); replicate so phi_switch of padded
    # segments advances past phi_max.
    seg_pad = np.ones(MAX_VIAS, dtype=dtype)
    seg_pad[0] = 0.0
    seg_pad[1 : l_traj] = seg_len

    # numpy leaves: construction stays transfer-only (no eager device ops,
    # each of which would be its own dispatch)
    state = PathState(
        p=pad(p_list, (3,)),
        r=pad(r_list, (3, 3)),
        r_tau=pad(r_tau, (3,)),
        iw=pad(iw, (3,)),
        dp=pad(dp, (3,)),
        dp_unit=pad([_unit(d) for d in dp], (3,)),
        dr=pad(dr_scaled, (3,)),
        dr_normed=pad(dr_normed, (3,)),
        seg_len=seg_pad,
        bp1=pad(bp1_l, (3,)),
        bp2=pad(bp2_l, (3,)),
        br1=pad(br1_l, (3,)),
        br2=pad(br2_l, (3,)),
        e_r_bound=pad(e_r_bound, (6,)),
        a_set=pad(a_norm, (MPC_SET_ROWS, 3)),
        b_set=pad(b_norm, (MPC_SET_ROWS,)),
        sector=np.asarray(0, np.int32),
        num_sectors=np.asarray(num_sectors, np.int32),
        phi_max=np.asarray(phi_max, dtype),
        phi_bias=np.asarray(phi_bias, dtype),
        switched=np.asarray(True),
    )
    return state


build_path_np = build_path


def path_window(state: PathState, nr_segs: int):
    """Extract the current nr_segs window (ref `get_parameters`,
    `get_basis_vectors`, `get_bound_params`, `ReferencePath.py:216-231`).

    Returns a dict of fixed-shape arrays:
      p_ref (nr_segs, 6), dp_ref (nr_segs, 6), dp_normed (nr_segs, 3),
      phi_switch (nr_segs+1,), bp1/bp2/br1/br2 (nr_segs, 3),
      e_r_bound (nr_segs, 6), a_set (nr_segs, 15, 3), b_set (nr_segs, 15),
      r_taud (nr_segs, 3)
    """
    idx = state.sector + jnp.arange(nr_segs)
    idx = jnp.clip(idx, 0, MAX_VIAS - 1)
    p_ref = jnp.concatenate([state.p[idx], state.iw[idx]], axis=1)  # (S, 6)
    dp_ref = jnp.concatenate([state.dp_unit[idx], state.dr[idx]], axis=1)
    cums = state.phi_cumsum
    idx_sw = jnp.clip(state.sector + jnp.arange(nr_segs + 1), 0, MAX_VIAS - 1)
    phi_switch = cums[idx_sw] + state.phi_bias
    return {
        "p_ref": p_ref,
        "dp_ref": dp_ref,
        "dp_normed": state.dr_normed[idx],
        "phi_switch": phi_switch,
        "bp1": state.bp1[idx],
        "bp2": state.bp2[idx],
        "br1": state.br1[idx],
        "br2": state.br2[idx],
        "e_r_bound": state.e_r_bound[idx],
        "a_set": state.a_set[idx],
        "b_set": state.b_set[idx],
        "r_taud": state.r_tau[idx],
        "r_vias": state.r[idx],
    }


def path_advance(state: PathState, switch) -> PathState:
    """Advance the window by one sector when ``switch`` is set and sectors
    remain (ref `ReferencePath.update`, `ReferencePath.py:187-207`)."""
    can = switch & (state.sector < state.num_sectors)
    return state._replace(
        sector=jnp.where(can, state.sector + 1, state.sector),
        switched=can,
    )


def path_apply_via_correction(state: PathState, seg_offset, p_new, phi_correction) -> PathState:
    """Functional version of the via-point snap-correction
    (ref `BoundMPC.py:992-1011`): move via point ``sector+seg_offset`` to
    ``p_new`` and shorten that segment's length by ``phi_correction``."""
    i = jnp.clip(state.sector + seg_offset, 0, MAX_VIAS - 1)
    p = state.p.at[i].set(p_new)
    seg_len = state.seg_len.at[i + 1].add(-phi_correction)
    # phi_max = cumsum up to num_sectors + 1 (ref `BoundMPC.py:1005-1010`)
    cums = jnp.cumsum(seg_len)
    phi_max = cums[jnp.clip(state.num_sectors + 1, 0, MAX_VIAS - 1)] + state.phi_bias
    return state._replace(p=p, seg_len=seg_len, phi_max=phi_max)
