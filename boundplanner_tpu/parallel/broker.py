"""Cross-scene batching broker for host-side planners.

The planner's graph search is irregular host logic (the reference runs it
per scene, single-threaded, with one native-solver call per request —
`BoundPlanner.py:174-584`), but its numeric leaves are fixed-shape device
kernels. When planning MANY scenes (BASELINE configs 4-5), running each
scene's kernels separately wastes the accelerator: every call ships a
batch-1 problem.

``BatchBroker`` lets N planner threads share vmapped executions: a call
enqueues its arguments under a kernel key; the first caller of a key
becomes the leader, lingers briefly so sibling threads (scenes progress
roughly in lockstep) can join, then stacks all queued argument pytrees,
runs ONE vmapped call padded to a power-of-two batch (bounded compile
cache), and scatters the per-slot results.

No deadlock by construction: a leader never waits for a specific number
of joiners — worst case it executes a batch of one after the linger
window.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List

import numpy as np

import jax
import jax.numpy as jnp


def _stack(args_list):
    return jax.tree.map(lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *args_list)


def _pad_pow2(batched, k: int, max_batch: int):
    # Never compile beyond max_batch (one compiled program per
    # power-of-two width up to it). Callers split batches larger than
    # max_batch into chunks before padding.
    if k > max_batch:
        raise ValueError(f"batch of {k} exceeds max_batch={max_batch}; chunk first")
    target = 1
    while target < k:
        target *= 2
    target = min(target, max_batch)

    def pad(leaf):
        if leaf.shape[0] == target:
            return leaf
        reps = jnp.broadcast_to(leaf[:1], (target - leaf.shape[0],) + leaf.shape[1:])
        return jnp.concatenate([leaf, reps])

    return jax.tree.map(pad, batched), target


class _Ticket:
    __slots__ = ("args", "event", "result")

    def __init__(self, args):
        self.args = args
        self.event = threading.Event()
        self.result = None


class BatchBroker:
    """Coalesces same-key kernel calls from multiple threads into one
    vmapped execution.

    register(key, fn): ``fn`` maps ONE call's args to its results; the
    broker wraps it with ``jax.vmap`` (all leading axes mapped).
    call(key, *args): blocks until the coalesced batch has run; returns
    this call's slice of the results as numpy.
    """

    def __init__(self, linger: float = 0.003, max_batch: int = 64):
        # Default linger is SHORT (3 ms): every leader call sleeps the full
        # window before executing, so low-concurrency callers should not pay
        # a coalescing budget. The fleet builder, whose 16-thread
        # measurement motivated a longer window,
        # passes linger=0.030 explicitly via `build_fleet_threaded`.
        self.linger = linger
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._pending: Dict[str, List[_Ticket]] = {}
        self._fns: Dict[str, Callable] = {}
        self.batches_run = 0
        self.calls_served = 0
        self.coalesced_calls = 0

    def register(self, key: str, fn: Callable):
        self._fns[key] = jax.jit(jax.vmap(fn))

    def call(self, key: str, *args) -> Any:
        ticket = _Ticket(args)
        with self._lock:
            queue = self._pending.setdefault(key, [])
            queue.append(ticket)
            leader = len(queue) == 1
        if not leader:
            ticket.event.wait()
            return ticket.result

        time.sleep(self.linger)
        with self._lock:
            batch = self._pending.pop(key)
        k = len(batch)
        # run in chunks of at most max_batch so the compiled batch sizes
        # stay in a small, bounded set {1, 2, ..., max_batch}
        n_runs = 0
        for lo in range(0, k, self.max_batch):
            chunk = batch[lo : lo + self.max_batch]
            stacked = _stack([t.args for t in chunk])
            padded, _ = _pad_pow2(stacked, len(chunk), self.max_batch)
            out = self._fns[key](*padded)
            out_np = jax.tree.map(np.asarray, out)
            n_runs += 1
            for i, t in enumerate(chunk):
                t.result = jax.tree.map(lambda leaf: leaf[i], out_np)
        with self._lock:
            self.batches_run += n_runs
            self.calls_served += k
            self.coalesced_calls += k - n_runs
        for t in batch:
            if t is not ticket:
                t.event.set()
        return ticket.result


def register_planner_kernels(broker, max_set_size: int = 20,
                             device_search: bool = False, max_via: int = 6):
    """Register the BoundPlanner device-kernel surface on a broker.

    Keys match the wrapper methods in `planner.BoundPlanner` (which route
    through `self.broker` when present): set growth, MVIE, intersection
    feasibility, EE-fit probing, and point projection.

    ``device_search`` additionally registers the batched min-plus
    shortest-path kernel ("spath", `planner.device_search`) and the
    planner then routes its roadmap searches through it. Off by default:
    a device call costs far more than a microsecond host Dijkstra, so it
    only pays when fleets of planners actually coalesce.
    """
    import functools

    from ..ops.mvie import mvie
    from ..ops.qp import solve_feasibility, solve_projection
    from ..planner.set_finder import find_set_around_point, find_set_line
    from ..planner.via_opt import fit_ee_in_set, solve_via_rot

    # the via-rotation NLP is shape-static per via count; register one key
    # per count so same-count scenes coalesce (`planner._via_points_for`
    # falls back to a direct call for rarer, larger counts)
    for k in range(1, max_via + 1):
        broker.register(
            f"via_rot_{k}", functools.partial(solve_via_rot, nr_via=k)
        )

    if device_search:
        from ..planner.device_search import shortest_path_device

        broker.register("spath", shortest_path_device)

    broker.register(
        "fsap",
        lambda p, obs, wmin, wmax: find_set_around_point(
            p, obs, wmin, wmax, fixed_mid=False, n_rows=max_set_size
        ),
    )
    broker.register(
        "fsap_mid",
        lambda p, obs, wmin, wmax: find_set_around_point(
            p, obs, wmin, wmax, fixed_mid=True, n_rows=max_set_size
        ),
    )
    broker.register(
        "fsl",
        lambda p0, p1, obs, wmin, wmax: find_set_line(
            p0, p1, obs, 0.0, wmin, wmax, limit_space=False,
            n_rows=max_set_size,
        ),
    )
    broker.register("mvie", lambda a, b: mvie(a, b))
    broker.register("feas", lambda a, b: solve_feasibility(a, b))
    broker.register("fit_ee", fit_ee_in_set)
    broker.register("proj", lambda a, b, t: solve_projection(a, b, t))
