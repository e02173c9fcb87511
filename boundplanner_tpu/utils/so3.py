"""SO(3) utilities as pure JAX functions.

Pure-JAX replacements for the numpy/CasADi dual-mode helpers of the
reference (`bound_planner/utils/optimization_functions.py:35-104`,
scipy ``Rotation`` conversions used throughout). Every function here is
jit/vmap/grad-safe: fixed shapes, no data-dependent branching (smooth
``where`` guards around the small-angle singularities).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-12


def skew(w):
    """3-vector -> skew-symmetric matrix (ref `optimization_functions.py:69-80`)."""
    w = jnp.asarray(w)
    z = jnp.zeros((), dtype=w.dtype)
    return jnp.stack(
        [
            jnp.stack([z, -w[2], w[1]]),
            jnp.stack([w[2], z, -w[0]]),
            jnp.stack([-w[1], w[0], z]),
        ]
    )


def rodrigues(axis, angle):
    """Rotation matrix from a *unit* axis and an angle
    (ref `optimization_functions.py:83-104`)."""
    omega = skew(axis)
    return (
        jnp.eye(3, dtype=omega.dtype)
        + jnp.sin(angle) * omega
        + (1.0 - jnp.cos(angle)) * (omega @ omega)
    )


def rotvec_to_matrix(rv):
    """exp: rotation vector (axis*angle) -> rotation matrix.

    Smooth at 0 via Taylor-guarded sinc coefficients.
    """
    rv = jnp.asarray(rv)
    theta2 = jnp.dot(rv, rv)
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    # sin(t)/t and (1-cos(t))/t^2 with Taylor fallbacks
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    omega = skew(rv)
    return jnp.eye(3, dtype=rv.dtype) + a * omega + b * (omega @ omega)


def matrix_to_quat(r):
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0.

    Branch-free Shepperd method (all four candidate quaternions computed,
    the numerically best selected with ``where``) so it is vmap/jit safe.
    """
    r = jnp.asarray(r)
    t = jnp.trace(r)
    d = jnp.diagonal(r)

    # Four candidates, each scaled by 4*component^2 (all >= 0).
    qw = jnp.stack(
        [1.0 + t, 1.0 + 2.0 * d[0] - t, 1.0 + 2.0 * d[1] - t, 1.0 + 2.0 * d[2] - t]
    )
    # candidate 0: largest w
    c0 = jnp.stack([qw[0], r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    # candidate 1: largest x
    c1 = jnp.stack([r[2, 1] - r[1, 2], qw[1], r[1, 0] + r[0, 1], r[0, 2] + r[2, 0]])
    # candidate 2: largest y
    c2 = jnp.stack([r[0, 2] - r[2, 0], r[1, 0] + r[0, 1], qw[2], r[2, 1] + r[1, 2]])
    # candidate 3: largest z
    c3 = jnp.stack([r[1, 0] - r[0, 1], r[0, 2] + r[2, 0], r[2, 1] + r[1, 2], qw[3]])

    cands = jnp.stack([c0, c1, c2, c3])  # (4, 4)
    idx = jnp.argmax(qw)
    q = cands[idx]
    q = q / jnp.linalg.norm(q)
    # canonicalize sign: w >= 0 (matches scipy's rotvec with angle in [0, pi])
    q = jnp.where(q[0] < 0, -q, q)
    return q


def quat_to_rotvec(q):
    """Unit quaternion (w,x,y,z, w>=0) -> rotation vector, |angle| <= pi."""
    w = q[0]
    v = q[1:]
    n = jnp.linalg.norm(v)
    angle = 2.0 * jnp.arctan2(n, w)
    small = n < 1e-8
    # scale = angle / sin(angle/2); near 0: angle ~ 2n/w, scale -> 2/w * (1 + n^2/(3 w^2))
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-12), angle / jnp.maximum(n, 1e-12))
    return scale * v


def matrix_to_rotvec(r):
    """log: rotation matrix -> rotation vector with angle in [0, pi].

    Numerically matches ``scipy.spatial.transform.Rotation.as_rotvec``.
    """
    return quat_to_rotvec(matrix_to_quat(r))


def matrix_to_euler_zyx(r):
    """Extrinsic z-y-x Euler angles, matching scipy ``as_euler("zyx")``
    (lowercase = extrinsic): R = Rx(gamma) @ Ry(beta) @ Rz(alpha), returned
    as [alpha, beta, gamma].

    Used by the initial-orientation-error decomposition
    (ref `bound_mpc_functions.py:41`). Gimbal lock (|r02| = 1) is handled
    the scipy way (third angle set to 0).
    """
    r = jnp.asarray(r)
    sb = jnp.clip(r[0, 2], -1.0, 1.0)
    beta = jnp.arcsin(sb)
    degenerate = jnp.abs(sb) > 1.0 - 1e-9
    alpha = jnp.where(
        degenerate,
        jnp.arctan2(r[1, 0], r[1, 1]),
        jnp.arctan2(-r[0, 1], r[0, 0]),
    )
    gamma = jnp.where(degenerate, 0.0, jnp.arctan2(-r[1, 2], r[2, 2]))
    return jnp.stack([alpha, beta, gamma])


def _jac_coeff(theta2):
    """Coefficient  1/t^2 - (1+cos t)/(2 t sin t)  with a Taylor guard.

    The reference evaluates this formula directly with ``t = |axis| + 1e-6``
    (`optimization_functions.py:35-66`); direct evaluation is catastrophic
    near t=0, so we switch to the series 1/12 + t^2/720 + t^4/30240.
    """
    theta = jnp.sqrt(theta2 + _EPS)
    small = theta2 < 1e-6
    theta_safe = jnp.where(small, 1.0, theta)
    direct = 1.0 / theta2 - (1.0 + jnp.cos(theta_safe)) / (
        2.0 * theta_safe * jnp.sin(theta_safe)
    )
    series = 1.0 / 12.0 + theta2 / 720.0 + theta2 * theta2 / 30240.0
    return jnp.where(small, series, direct)


def jac_so3_inv_right(axis):
    """Inverse of the right Jacobian of SO(3) at rotation vector ``axis``
    (ref `optimization_functions.py:35-49`)."""
    axis = jnp.asarray(axis)
    omega = skew(axis)
    theta2 = jnp.dot(axis, axis)
    return jnp.eye(3, dtype=axis.dtype) + 0.5 * omega + _jac_coeff(theta2) * (omega @ omega)


def jac_so3_inv_left(axis):
    """Inverse of the left Jacobian of SO(3) (ref `optimization_functions.py:52-66`)."""
    axis = jnp.asarray(axis)
    omega = skew(axis)
    theta2 = jnp.dot(axis, axis)
    return jnp.eye(3, dtype=axis.dtype) - 0.5 * omega + _jac_coeff(theta2) * (omega @ omega)


def gram_schmidt(v, b):
    """One Gram-Schmidt step: remove the projection of ``b`` onto ``v``
    (ref `util_functions.py:108-116`)."""
    return b - jnp.dot(v, b) * v


def normalize(v, eps=1e-12):
    return v / (jnp.linalg.norm(v) + eps)
