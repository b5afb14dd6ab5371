"""Broadcast relay trees for the planner (CMM §3.4 transfer pricing).

The pure planning part of the JAX reference's ``repro.runtime.wire``: the
deterministic relay-tree shape the simulator prices one-producer-many-
consumer edges with.  The wire codecs and the executors' transfer path
belong to the multi-process runtime, which this package does not carry yet.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

#: minimum cross-node destination count before a relay tree beats
#: N unicasts (at 2 destinations the tree *is* two unicasts).
BCAST_MIN_FANOUT = 3


def broadcast_tree(src: int, dsts: Sequence[int]) -> Dict[int, List[int]]:
    """Deterministic binary relay tree for one fan-out edge.

    Maps each relay node to its children over ``[src] + sorted(dsts)``
    (node at position ``i`` feeds positions ``2i+1`` and ``2i+2``).
    Below ``BCAST_MIN_FANOUT`` destinations the "tree" is the flat N-unicast
    star rooted at ``src`` — a tree of depth one.  The simulator prices
    fan-out transfers along this shape.
    """
    order = [src] + sorted(set(int(d) for d in dsts) - {src})
    tree: Dict[int, List[int]] = {}
    if len(order) - 1 < BCAST_MIN_FANOUT:
        if len(order) > 1:
            tree[src] = order[1:]
        return tree
    for i, parent in enumerate(order):
        kids = order[2 * i + 1: 2 * i + 3]
        if kids:
            tree[parent] = kids
    return tree
