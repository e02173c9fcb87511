"""Phase-synchronous cross-scene batching for fleet planning.

STATUS: DOCUMENTED NEGATIVE — not adopted. On CPU it loses 1.3x to the
linger-window broker (compute-bound). Even where dispatch latency
dominates, it cuts dispatches and widens batches yet loses wall time:
every barrier wave runs at the pace of the slowest parked scene, beating
the latency saved, and the waves narrow as scenes finish. It has not
been measured on the GPU.
Production fleet builds use `build_fleet_threaded` (<512 scenes) or
`build_fleet_mp` (>=512) via `fleet_cache.ensure`. Kept, with tests, as
the experimental record.

The linger-window broker (`parallel.broker.BatchBroker`) coalesces planner
kernel calls by SLEEPING at each leader call and hoping siblings arrive in
the window; measured on 16-scene fleets it tops out at 1.2-1.6 calls per
batch because scenes desynchronize through the irregular graph search. ``PhaseSyncBroker`` replaces the time window
with a BARRIER: every planning worker registers itself, a kernel call
parks its request, and the moment the LAST active worker parks (i.e. no
worker can make progress without a device result) the whole pending pool
is flushed — every key's queue runs as ONE chunked, power-of-two-padded
vmapped execution. Scenes therefore advance through the planner in
lockstep waves and every device call carries the full set of pending
same-key problems, with zero sleeps and no tuning knob.

This is the phase-synchronous batched planner of SURVEY.md §7 phase 6:
the reference plans one scene at a time with one native
solver call per request (`bound_planner/BoundPlanner/BoundPlanner.py:174-584`);
here N scenes' pending `find_set_around_point` / `find_set_line` /
feasibility / fit / projection / via-rot-NLP calls become single batched
kernels per growth round.

Deadlock-freedom: flush fires exactly when blocked == active, and a worker
is always either runnable, parked in :meth:`call`, or deregistered (a
``finally`` in :func:`~boundplanner_tpu.parallel.fleet.build_fleet_sync`'s
worker loop guarantees deregistration on any exception) — so the last
parker or the last deregistering worker always triggers the flush.
Startup raggedness: the SPAWNER must call :meth:`worker_enter` once per
worker BEFORE starting the threads — otherwise an early worker that
parks before its siblings register sees blocked == active and flushes a
narrow batch.
Kernel-execution exceptions are delivered to every parked ticket of the
failing key and re-raised in the waiting threads.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

import numpy as np

import jax

_PENDING = object()  # sentinel: ticket not served yet


def _stack_np(args_list):
    """Stack call-arg pytrees on the HOST (one transfer at dispatch instead
    of one device put per scene per leaf)."""
    return jax.tree.map(
        lambda *xs: np.stack([np.asarray(x) for x in xs]), *args_list
    )


def _pad_pow2_np(batched, k: int, max_batch: int):
    """Pad the leading axis to the next power of two (bounded compile-cache
    width set {1, 2, 4, ..., max_batch})."""
    target = 1
    while target < k:
        target *= 2
    target = min(target, max_batch)

    def pad(leaf):
        if leaf.shape[0] == target:
            return leaf
        reps = np.broadcast_to(
            leaf[:1], (target - leaf.shape[0],) + leaf.shape[1:]
        )
        return np.concatenate([leaf, reps])

    return jax.tree.map(pad, batched), target


class _Ticket:
    __slots__ = ("args", "result", "error")

    def __init__(self, args):
        self.args = args
        self.result = _PENDING
        self.error = None


class PhaseSyncBroker:
    """Barrier-flushed batching broker for N cooperating planner threads.

    register(key, fn): ``fn`` maps ONE call's args to its results; wrapped
    with ``jax.vmap`` + ``jax.jit``.
    worker_enter()/worker_exit(): bracket a planning worker's lifetime.
    The spawner calls worker_enter for ALL workers before starting any
    (see module docstring); each worker calls worker_exit when done.
    call(key, *args): park until the coalesced batch has run; returns this
    call's slice of the results as numpy.
    """

    def __init__(self, max_batch: int = 256):
        self.max_batch = max_batch
        self._cond = threading.Condition()
        self._pending: Dict[str, List[_Ticket]] = {}
        self._fns: Dict[str, Callable] = {}
        self._active = 0
        self._blocked = 0
        self._flushing = False
        # stats
        self.batches_run = 0
        self.calls_served = 0
        self.coalesced_calls = 0
        self.width_hist: Dict[int, int] = {}

    # ------------------------------------------------------------------
    def register(self, key: str, fn: Callable):
        self._fns[key] = jax.jit(jax.vmap(fn))

    def worker_enter(self):
        with self._cond:
            self._active += 1

    def worker_exit(self):
        with self._cond:
            self._active -= 1
            self._maybe_flush_locked()

    # ------------------------------------------------------------------
    def call(self, key: str, *args) -> Any:
        if key not in self._fns:
            raise KeyError(f"kernel {key!r} not registered")
        ticket = _Ticket(args)
        with self._cond:
            self._pending.setdefault(key, []).append(ticket)
            self._blocked += 1
            self._maybe_flush_locked()
            # NOTE: ``self._blocked`` is decremented by the FLUSHER at
            # delivery time, not here — a served-but-not-yet-woken thread
            # is runnable, and counting it as parked would let a fast
            # sibling that re-parks trigger a premature width-1 flush.
            while ticket.result is _PENDING and ticket.error is None:
                self._cond.wait()
        if ticket.error is not None:
            raise ticket.error
        return ticket.result

    # ------------------------------------------------------------------
    def _maybe_flush_locked(self):
        """Caller holds the lock. Flush when every active worker is parked
        (or when the last worker deregistered with requests still queued)."""
        if self._flushing:
            return
        if not self._pending:
            return
        if self._blocked < self._active or self._blocked == 0:
            return
        self._flushing = True
        pool = self._pending
        self._pending = {}
        served = sum(len(v) for v in pool.values())
        self._cond.release()
        try:
            for key, batch in pool.items():
                self._run_key(key, batch)
        finally:
            self._cond.acquire()
            self._flushing = False
            self._blocked -= served
            self._cond.notify_all()
            # requests that raced the flush window: re-check
            self._maybe_flush_locked()

    def _run_key(self, key: str, batch: List[_Ticket]):
        """Run one key's queue in max_batch chunks (pow-2 padded so the
        compile cache stays bounded). No lock held."""
        try:
            fn = self._fns[key]
            n_runs = 0
            for lo in range(0, len(batch), self.max_batch):
                chunk = batch[lo : lo + self.max_batch]
                stacked = _stack_np([t.args for t in chunk])
                padded, width = _pad_pow2_np(stacked, len(chunk), self.max_batch)
                out = fn(*padded)
                out_np = jax.tree.map(np.asarray, out)
                n_runs += 1
                self.width_hist[width] = self.width_hist.get(width, 0) + 1
                for i, t in enumerate(chunk):
                    t.result = jax.tree.map(lambda leaf: leaf[i], out_np)
            self.batches_run += n_runs
            self.calls_served += len(batch)
            self.coalesced_calls += len(batch) - n_runs
        except Exception as e:  # deliver to every parked caller of this key
            for t in batch:
                if t.result is _PENDING:
                    t.error = e

    # ------------------------------------------------------------------
    @property
    def stats(self) -> dict:
        return {
            "calls_served": self.calls_served,
            "batches_run": self.batches_run,
            "coalesced_calls": self.coalesced_calls,
            "mean_width": (self.calls_served / self.batches_run)
            if self.batches_run
            else 0.0,
            "width_hist": dict(sorted(self.width_hist.items())),
        }
