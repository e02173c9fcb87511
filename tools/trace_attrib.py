"""Reduce a JAX profiler trace to device time per named scope.

Reads the newest ``*.xplane.pb`` under a trace directory (written by
``jax.profiler.trace(dir)``), keeps the events of the device planes
(``/device:GPU:*``), and sums their durations:

- in total, and as the union of busy intervals over the traced window
  (device idle share = 1 - busy / window);
- per scope: an event belongs to the first of ``--scopes`` whose name
  appears in the event's name or in its ``tf_op``/``hlo_op``/``name``
  stats (the op names carry ``jax.named_scope`` prefixes);
- per kernel name (top 15).

Usage: python tools/trace_attrib.py TRACE_DIR [--scopes=a,b,...] [--top=15]
"""

from __future__ import annotations

import os
import sys
from collections import defaultdict

DEVICE_PREFIX = "/device:GPU"
OP_STATS = ("tf_op", "hlo_op", "long_name", "name")


def find_xplane(root: str) -> str:
    hits = [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if f.endswith(".xplane.pb")]
    if not hits:
        raise SystemExit(f"no *.xplane.pb under {root}")
    return max(hits, key=os.path.getmtime)


def device_events(path: str):
    """(start_ns, duration_ns, name, op text) of every device-plane event."""
    import jax

    data = jax.profiler.ProfileData.from_file(path)
    for plane in data.planes:
        if not plane.name.startswith(DEVICE_PREFIX):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                ops = " ".join(str(stats.get(k, "")) for k in OP_STATS)
                yield ev.start_ns, ev.duration_ns, ev.name, ops


def longest_events(path: str, k: int = 10):
    """The ``k`` longest device events with all their stats (to see which
    names a trace carries before attributing by them)."""
    import jax

    data = jax.profiler.ProfileData.from_file(path)
    evs = []
    for plane in data.planes:
        if plane.name.startswith(DEVICE_PREFIX):
            for line in plane.lines:
                evs += [(ev.duration_ns, ev.name, {n: str(v)[:200] for n, v in ev.stats})
                        for ev in line.events]
    return sorted(evs, key=lambda e: -e[0])[:k]


def busy_ns(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def attribute(events, scopes):
    """Per-scope and per-kernel device time plus busy/window totals (ns)."""
    by_scope = defaultdict(float)
    by_name = defaultdict(float)
    intervals = []
    for start, dur, name, ops in events:
        intervals.append((start, start + dur))
        by_name[name] += dur
        text = f"{name} {ops}"
        scope = next((s for s in scopes if s in text), "<other>")
        by_scope[scope] += dur
    total = sum(by_name.values())
    window = (max(e for _, e in intervals) - min(s for s, _ in intervals)
              if intervals else 0.0)
    return {"total_ns": total, "busy_ns": busy_ns(intervals),
            "window_ns": window, "by_scope": dict(by_scope),
            "by_name": dict(by_name)}


def main(argv):
    if not argv:
        raise SystemExit(__doc__)
    root = argv[0]
    scopes, top = [], 15
    for a in argv[1:]:
        if a.startswith("--scopes="):
            scopes = [s for s in a.split("=", 1)[1].split(",") if s]
        elif a.startswith("--top="):
            top = int(a.split("=", 1)[1])
    path = find_xplane(root)
    r = attribute(device_events(path), scopes)
    total = max(r["total_ns"], 1.0)
    print(f"trace: {path}")
    print(f"device op time {r['total_ns'] / 1e6:.3f} ms, busy "
          f"{r['busy_ns'] / 1e6:.3f} ms of a {r['window_ns'] / 1e6:.3f} ms "
          f"window (idle share "
          f"{1 - r['busy_ns'] / max(r['window_ns'], 1.0):.3f})")
    print("== by scope ==")
    for s, ns in sorted(r["by_scope"].items(), key=lambda kv: -kv[1]):
        print(f"{ns / 1e6:10.3f} ms  {100 * ns / total:5.1f}%  {s}")
    print(f"== by kernel name (top {top}) ==")
    for s, ns in sorted(r["by_name"].items(), key=lambda kv: -kv[1])[:top]:
        print(f"{ns / 1e6:10.3f} ms  {100 * ns / total:5.1f}%  {s[:120]}")
    return r


if __name__ == "__main__":
    main(sys.argv[1:])
