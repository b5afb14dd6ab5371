"""Node-level cache (CMM §3.5), the planning half of the JAX reference's
``repro.core.cache``.

When a tile produced on node A is consumed on node B, the transferred copy is
kept in B's main memory.  Subsequent consumers of the *same tile version* on B
incur zero communication.  A tile version is identified by the producer task
id — accumulation chains (addmul) create a new version per step, so stale
partial sums are never reused.

The cache is unbounded, as the paper's main memory is; the reference's
optional LRU capacity, pinning and invalidation serve its experiments and
multi-process executors and come with them.
"""
from __future__ import annotations

from typing import Hashable


class NodeCache:
    def __init__(self, n_nodes: int):
        self._c = [set() for _ in range(n_nodes)]
        self.hits = 0
        self.misses = 0

    def peek(self, node: int, key: Hashable) -> bool:
        """Whether ``node`` holds ``key`` (no hit/miss count)."""
        return key in self._c[node]

    def put(self, node: int, key: Hashable):
        self._c[node].add(key)
