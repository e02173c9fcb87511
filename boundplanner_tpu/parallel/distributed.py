"""Multi-process tier: fleets sharded over every process of a cluster.

New design — nothing distributed exists in the reference (SURVEY.md §2.3);
this is the N>=2-hosts rung of the BASELINE measurement ladder. The model:

- every host runs the SAME program (SPMD) and calls :func:`initialize`
  first, which wires `jax.distributed` (coordinator + peers) so
  ``jax.devices()`` becomes the GLOBAL device list;
- the fleet lives on a single global ``scenario`` mesh axis laid over all
  devices of all processes. Each process feeds only its addressable shard
  of the batch
  (:func:`global_from_local` / `jax.make_array_from_process_local_data`);
- the jitted rollout is byte-identical to the single-host path
  (`mesh.sharded_rollout`'s `run`); scenes never communicate, so the only
  cross-process traffic is the final diagnostic reductions (mean success,
  max violation), which XLA lowers to collectives;
- results come back per host as the local shards (:func:`local_from_global`)
  plus replicated global diagnostics.

Tested by spawning real extra processes on a virtual CPU mesh
(`tests/test_distributed.py`): two processes x 4 virtual devices must
reproduce the single-process 8-device fleet exactly.

CLI launcher (one command fans out N local processes, one GPU each, e.g.
to run a multi-host topology on one machine)::

    python -m boundplanner_tpu.parallel.distributed --nproc 2 -- \
        python my_fleet_script.py

Each child inherits BOUNDPLANNER_DIST_{COORD,NPROCS,PID} and calls
``initialize()`` with no arguments. Child ``i`` sees only the ``i``-th
visible GPU (``CUDA_VISIBLE_DEVICES``): a JAX process reserves most of the
memory of every card it opens, so two processes must never share one.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from typing import Optional, Sequence

import numpy as np

ENV_COORD = "BOUNDPLANNER_DIST_COORD"
ENV_NPROCS = "BOUNDPLANNER_DIST_NPROCS"
ENV_PID = "BOUNDPLANNER_DIST_PID"


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    cpu_collectives: str = "gloo",
) -> None:
    """Join the distributed runtime. Call BEFORE any other jax use.

    Arguments default to the ``BOUNDPLANNER_DIST_*`` environment variables
    set by the launcher. On CPU backends the cross-process collective
    implementation must be selected before backend init (gloo); GPU
    backends ignore it (their collectives go through NCCL).
    """
    import jax

    if coordinator_address is None:
        coordinator_address = os.environ[ENV_COORD]
    if num_processes is None:
        num_processes = int(os.environ[ENV_NPROCS])
    if process_id is None:
        process_id = int(os.environ[ENV_PID])
    try:
        jax.config.update("jax_cpu_collectives_implementation", cpu_collectives)
    except Exception:  # config knob absent on some builds
        pass
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_initialized() -> bool:
    import jax

    return jax.process_count() > 1


def global_scenario_mesh(axis: str = "scenario"):
    """Mesh over ALL devices of ALL processes."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def local_batch_slice(global_batch: int) -> slice:
    """The slice of the global scenario axis this process must feed.

    The scenario axis is laid out in device order; with D global devices
    and P processes each process owns a contiguous block of
    ``global_batch / P`` scenes (global_batch must divide evenly over
    devices).
    """
    import jax

    nproc = jax.process_count()
    if global_batch % nproc:
        raise ValueError(f"global batch {global_batch} not divisible by "
                         f"{nproc} processes")
    per = global_batch // nproc
    pid = jax.process_index()
    return slice(pid * per, (pid + 1) * per)


def global_from_local(tree_local, mesh, global_batch: int, axis: str = "scenario"):
    """Assemble globally-sharded arrays from THIS process's shard of the
    batch (leading axis = ``global_batch / process_count`` scenes)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        x = np.asarray(x)
        sh = NamedSharding(mesh, P(axis, *([None] * (x.ndim - 1))))
        return jax.make_array_from_process_local_data(
            sh, x, global_shape=(global_batch,) + x.shape[1:]
        )

    return jax.tree.map(put, tree_local)


def local_from_global(tree_global):
    """This process's addressable shard of a globally-sharded pytree, as
    host numpy arrays (leading axis = local scene count)."""
    import jax

    def get(x):
        shards = sorted(
            (s for s in x.addressable_shards), key=lambda s: s.index[0].start or 0
        )
        return np.concatenate([np.asarray(s.data) for s in shards], axis=0)

    return jax.tree.map(get, tree_global)


def distributed_rollout(carry_local, q0_local, obs_local, cfg, n_ticks: int,
                        mesh=None, axis: str = "scenario"):
    """Closed-loop fleet rollout across every host of the slice.

    Inputs are this process's scenes only (leading axis = local count,
    equal on every process). Returns ``(final_local, recs_local, diag)``
    where the first two are host numpy shards of this process's scenes and
    ``diag`` holds fleet-global reductions (identical on every process —
    cross-process psum/pmax collectives).
    """
    import jax
    import jax.numpy as jnp
    import functools

    from .batch import closed_loop_rollout

    if mesh is None:
        mesh = global_scenario_mesh(axis)
    local_n = np.asarray(jax.tree.leaves(q0_local)[0]).shape[0]
    global_batch = local_n * jax.process_count()

    carry = global_from_local(carry_local, mesh, global_batch, axis)
    q0 = global_from_local(q0_local, mesh, global_batch, axis)
    obs = global_from_local(obs_local, mesh, global_batch, axis)

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

    final, recs, diag = run(carry, q0, obs, cfg, n_ticks)
    diag = {k: float(v) for k, v in diag.items()}
    return local_from_global(final), local_from_global(recs), diag


# ----------------------------------------------------------------------
# launcher


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(cmd: Sequence[str], nproc: int, env_extra: Optional[dict] = None,
           timeout: Optional[float] = None) -> list:
    """Spawn ``nproc`` copies of ``cmd`` wired to one coordinator; wait for
    all; return the (returncode, output) list (raises on nonzero exit).
    Child ``i`` gets the ``i``-th entry of ``CUDA_VISIBLE_DEVICES`` (from
    ``env_extra`` or this process; card ``i`` when unset) as its only GPU."""
    coord = f"localhost:{free_port()}"
    base = dict(os.environ)
    base.update(env_extra or {})
    visible = [d for d in base.get("CUDA_VISIBLE_DEVICES", "").split(",") if d]
    if visible and len(visible) < nproc:
        raise ValueError(f"{nproc} processes but only {len(visible)} visible "
                         f"GPUs ({','.join(visible)})")
    procs = []
    for pid in range(nproc):
        env = dict(base)
        env["CUDA_VISIBLE_DEVICES"] = visible[pid] if visible else str(pid)
        env[ENV_COORD] = coord
        env[ENV_NPROCS] = str(nproc)
        env[ENV_PID] = str(pid)
        procs.append(subprocess.Popen(
            list(cmd), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    results = []
    failed = []
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=timeout)
        results.append((p.returncode, out))
        if p.returncode != 0:
            failed.append((pid, out))
    if failed:
        msgs = "\n".join(f"--- process {pid} ---\n{out}" for pid, out in failed)
        raise RuntimeError(f"{len(failed)}/{nproc} processes failed:\n{msgs}")
    return results


def _main(argv):
    import argparse

    ap = argparse.ArgumentParser(
        description="Fan out N coordinated processes of a fleet program."
    )
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("cmd", nargs=argparse.REMAINDER,
                    help="command to run (prefix with --)")
    args = ap.parse_args(argv)
    cmd = args.cmd[1:] if args.cmd and args.cmd[0] == "--" else args.cmd
    if not cmd:
        ap.error("no command given")
    for rc, out in launch(cmd, args.nproc):
        sys.stdout.write(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main(sys.argv[1:]))
