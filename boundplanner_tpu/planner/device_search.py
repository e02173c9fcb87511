"""On-device batched shortest paths over padded roadmap adjacency.

SURVEY §7 phase 6 tail: the planner's per-scene Dijkstra
(`roadmap.SetRoadmap.shortest_path`, replacing `nx.shortest_path` at
`bound_planner/BoundPlanner/BoundPlanner.py:434`) is a microsecond host
operation for one scene — but a 10k-scene fleet issues one per planner
iteration per scene. With junction counts padded to a fixed size, the
whole fleet's searches become ONE device call: a masked min-plus
Bellman-Ford relaxation (`lax.fori_loop` of (n, n) broadcasts — fixed
trip count, vmappable) with predecessor tracking and fixed-length path
extraction.

Re-design note: Dijkstra's priority queue is inherently sequential and
data-dependent — the batched formulation is the dense relaxation,
which wastes FLOPs on tiny graphs but is batch-parallel and fixed-shape.
Adoption is measured, not assumed: a device call costs far more than a
microsecond host Dijkstra, so `BoundPlanner` only routes through this
kernel when a broker with the "spath" key is attached AND scenes can
coalesce. It has not been measured on the GPU.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

NO_EDGE = np.float32(1e18)


@functools.partial(jax.jit, static_argnames=("src", "dst"))
def shortest_path_device(adj, src: int = 0, dst: int = 1):
    """Single-source shortest path on a dense padded adjacency matrix.

    adj: (n, n) float32; ``NO_EDGE`` where there is no edge (diagonal
    irrelevant). Returns (dist, path, reached): ``path`` is (n,) int32,
    the node sequence src..dst padded with -1 AFTER the dst entry.
    ``vmap`` over a leading batch axis for fleets.
    """
    n = adj.shape[-1]
    idx = jnp.arange(n)
    dist = jnp.full((n,), NO_EDGE, adj.dtype).at[src].set(0.0)
    prev = jnp.full((n,), -1, jnp.int32).at[src].set(src)

    def relax(_, carry):
        dist, prev = carry
        cand = dist[:, None] + adj                 # via-u costs, (n, n)
        best = jnp.min(cand, axis=0)
        best_u = jnp.argmin(cand, axis=0).astype(jnp.int32)
        improved = best < dist * (1.0 - 1e-7) - 1e-12
        return jnp.where(improved, best, dist), jnp.where(improved, best_u, prev)

    dist, prev = jax.lax.fori_loop(0, n - 1, relax, (dist, prev))
    reached = dist[dst] < 0.5 * NO_EDGE

    # walk predecessors dst -> src (reverse order), fixed n steps
    def walk(cur, _):
        nxt = jnp.where((cur == src) | (cur < 0), -1, prev[cur])
        return nxt, cur

    _, rev = jax.lax.scan(walk, jnp.asarray(dst, jnp.int32), None, length=n)
    # rev = [dst, ..., src, -1, -1, ...]; reverse the valid prefix in place
    length = jnp.sum((rev >= 0).astype(jnp.int32))
    pos = length - 1 - idx                          # source index for slot i
    path = jnp.where(idx < length, rev[jnp.clip(pos, 0, n - 1)], -1)
    path = jnp.where(reached, path, jnp.full((n,), -1, jnp.int32))
    return dist[dst], path.astype(jnp.int32), reached


def roadmap_adjacency(roadmap, n_pad: int, dtype=np.float32):
    """Dense padded adjacency of a `SetRoadmap` (numpy, host-side)."""
    n = len(roadmap.junctions)
    if n > n_pad:
        raise ValueError(f"{n} junctions exceed pad size {n_pad}")
    adj = np.full((n_pad, n_pad), NO_EDGE, dtype)
    for u, nbrs in enumerate(roadmap._adj):
        for v, w in nbrs.items():
            adj[u, v] = w
    return adj


def fleet_shortest_paths(roadmaps, n_pad: int = 64):
    """One device call for a whole fleet's roadmap searches.

    Returns a list of node-id lists (like `SetRoadmap.shortest_path`);
    raises RuntimeError for any unreached scene (matching the host
    method's contract)."""
    adj = np.stack([roadmap_adjacency(r, n_pad) for r in roadmaps])
    dist, paths, reached = jax.vmap(shortest_path_device)(jnp.asarray(adj))
    reached = np.asarray(reached)
    if not reached.all():
        bad = np.nonzero(~reached)[0].tolist()
        raise RuntimeError(f"roadmap: start and end not connected: scenes {bad}")
    out = []
    for row in np.asarray(paths):
        out.append([int(x) for x in row if x >= 0])
    return out
