"""Preferential-attachment graphs (Barabasi-Albert) made in bulk.

The law is that of the sequential algorithm FirstOrderLp.jl's PageRank
generator uses (LightGraphs' undirected barabasi_albert): node `degree`
joins nodes 0 .. degree-1; every later node v joins `degree` distinct
earlier nodes, each drawn with probability proportional to its degree.
The sequential form keeps a pool that lists every node once per edge end
(node v's block: v `degree` times, then its targets) and draws a uniform
position in it. Here every node's draws are made at once as positions
in that pool (Batagelj and Brandes, Phys. Rev. E 71, 036113, 2005): a
position in a block's first half is the block's own node; one in its
second half is another node's draw, resolved by pointer jumping. A node
whose draws resolve to the same target draws the later ones again until
its targets are distinct, as the sequential algorithm rejects them.
"""

from __future__ import annotations

import numpy as np

_MAX_ROUNDS = 64


def _resolve(pos: np.ndarray, degree: int, first: np.ndarray) -> np.ndarray:
    """The node each draw holds: draw s >= degree (of node
    degree + s // degree) at pool position pos[s - degree]; draws
    0 .. degree-1 are node `degree`'s fixed targets `first`."""
    d = degree
    block, offset = np.divmod(pos, 2 * d)
    own = offset < d
    value = np.concatenate([first, np.where(own, d + block, -1)])
    # a position in a block's second half holds that block's draw
    ptr = np.concatenate([np.full(d, -1, np.int64),
                          np.where(own, -1, block * d + offset - d)])
    todo = np.flatnonzero(value < 0)
    while todo.size:
        nxt = ptr[todo]  # always an earlier draw
        got = value[nxt]
        done = got >= 0
        value[todo[done]] = got[done]
        rest = todo[~done]
        ptr[rest] = ptr[nxt[~done]]  # jump: halves every chain
        todo = rest
    return value


def edges(num_nodes: int, degree: int, rng: np.random.Generator):
    """(sources, targets) of the graph's edges, each source a node that
    joined after its target: degree * (num_nodes - degree) edges."""
    n, d = int(num_nodes), int(degree)
    if d < 1 or d >= n:
        raise ValueError("need 1 <= degree < num_nodes")
    num_new = n - d
    first = np.arange(d, dtype=np.int64)
    # draw slot s = (v - d) d + j of node v > d: a position below the
    # pool's length when v joins, 2 d (v - d)
    later = np.repeat(np.arange(d + 1, n, dtype=np.int64), d)
    high = 2 * d * (later - d)
    pos = rng.integers(0, high)
    slot_pos = np.concatenate([np.full(d, -1, np.int64), pos])
    for _ in range(_MAX_ROUNDS):
        targets = _resolve(slot_pos[d:], d, first)
        per_node = targets.reshape(num_new, d)
        dup = np.zeros(per_node.shape, dtype=bool)
        for j in range(1, d):
            dup[:, j] = (per_node[:, :j] == per_node[:, j:j + 1]).any(axis=1)
        if not dup.any():
            break
        redo = np.flatnonzero(dup.ravel())
        slot_pos[redo] = rng.integers(0, high[redo - d])
    else:
        raise RuntimeError("duplicate draws did not clear")
    sources = np.repeat(np.arange(d, n, dtype=np.int64), d)
    return sources, targets
