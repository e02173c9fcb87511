"""Device-mesh scaling: scenario-sharded fleets over several devices.

New design (nothing distributed exists in the reference, SURVEY.md §2.3):
scenes are embarrassingly parallel, so the natural mesh is a single flat
``scenario`` axis over all devices (the GPUs of one host are joined all
to all, so no axis order is better than another). Batched pytrees are sharded on their
leading axis with ``NamedSharding``; XLA partitions the vmapped fused tick
with zero cross-device communication in the hot loop, and diagnostics
(success counts, max violations) are combined with ``psum``-style
collectives at the end of a rollout. Multi-host DCN fleets use the same
spec: each host feeds its addressable shard.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MPCParams
from .batch import (batched_mpc_tick, closed_loop_rollout,
                    executed_ee_penetration, fleet_rollout)


def make_mesh(n_devices: int | None = None, axis: str = "scenario") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def shard_batch(tree, mesh: Mesh, axis: str = "scenario"):
    """Shard every leaf of a batched pytree along its leading axis."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        x = jnp.asarray(x)
        if x.ndim == 0:
            return jax.device_put(x, NamedSharding(mesh, P()))
        return jax.device_put(x, sharding)

    return jax.tree.map(put, tree)


def sharded_rollout(carry, q0, obs, cfg: MPCParams, n_ticks: int, mesh: Mesh):
    """Closed-loop fleet rollout, scenario-sharded over the mesh.

    ``carry``/``q0``/``obs`` must carry a leading scenario axis divisible by
    the mesh size. Returns (final carries, per-tick records, diagnostics).
    """
    carry = shard_batch(carry, mesh)
    q0 = shard_batch(q0, mesh)
    obs = shard_batch(obs, mesh)

    @functools.partial(jax.jit, static_argnames=("cfg_", "n_"))
    def run(carry, q0, obs, cfg_, n_):
        final, recs = jax.vmap(
            lambda c, q, o: closed_loop_rollout(c, q, o, cfg_, n_)
        )(carry, q0, obs)
        diag = {
            "success_rate": jnp.mean(recs["success"].astype(jnp.float32)),
            "max_viol": jnp.max(recs["viol"]),
            "mean_phi_final": jnp.mean(recs["phi"][:, -1]),
        }
        return final, recs, diag

    return run(carry, q0, obs, cfg, n_ticks)


def mesh_fleet_rollout(carry_b, q0_b, obs_b, cfg: MPCParams, n_ticks: int,
                       mesh: Mesh, axis: str = "scenario"):
    """`fleet_rollout` with the batch sharded over ``mesh``, plus the fleet
    quality diagnostics reduced across devices.

    The batch is fed through the multi-host shard-feeding path
    (`parallel.distributed.global_from_local`), which on one process
    reduces to a sharded device_put. Returns (per-tick phi (B, T),
    diagnostics dict of floats, the sharded inputs)."""
    from . import distributed as dist

    batch = int(np.shape(q0_b)[0])
    inputs = (
        dist.global_from_local(carry_b, mesh, batch, axis),
        dist.global_from_local(np.asarray(q0_b, np.float32), mesh, batch, axis),
        dist.global_from_local(obs_b, mesh, batch, axis),
    )

    @jax.jit
    def run(carry, q0, obs):
        _, recs = fleet_rollout(carry, q0, obs, cfg, n_ticks)
        enter, dig_in = executed_ee_penetration(recs["p"], obs)
        diag = {
            "success_rate": jnp.mean(recs["success"].astype(jnp.float32)),
            "max_viol": jnp.max(recs["viol"]),
            "mean_phi_final": jnp.mean(recs["phi"][:, -1]),
            "ee_enter_m": enter,
            "ee_dig_in_m": dig_in,
        }
        return recs["phi"], diag

    phis, diag = run(*inputs)
    return np.asarray(phis), {k: float(v) for k, v in diag.items()}, inputs

