"""Discrete-event schedule simulator (CMM §3.3, §4.2).

Simulates a HEFT schedule under the profiled time model, with the machine
model's resources made explicit:

* each node has ``worker_procs`` compute slots (a task occupies one);
* each node has ``comm_procs`` communication slots — a cross-node transfer
  occupies one slot at the sender *and* one at the receiver for its duration
  (the paper's dedicated communication processes; the master has more);
* ``calloc`` is asynchronous: it does not occupy a worker slot (§3.3);
* the node-level cache absorbs repeated transfers of the same tile version
  (§3.5) — transfers in flight are joined, not duplicated.

The simulator is what the engine uses for tile-size auto-selection (§3.3).
It is the JAX reference's (``repro.core.simulator``), event for event, so
both packages predict the same makespan for the same schedule.
"""
from __future__ import annotations

import heapq
import itertools
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from .cache import NodeCache
from .graph import TaskGraph, TaskKind
from .heft import Schedule, edge_bytes
from .machine import ClusterSpec
from .timemodel import CostCache, TimeModel
from ..runtime.wire import BCAST_MIN_FANOUT, broadcast_tree


@dataclass
class Interval:
    tid: int
    kind: str
    node: int
    slot: int
    start: float
    end: float


@dataclass
class Transfer:
    key: Tuple[int, int]
    src: int
    dst: int
    nbytes: int
    start: float = 0.0
    end: float = 0.0


@dataclass
class SimResult:
    makespan: float
    intervals: List[Interval]
    transfers: List[Transfer]
    cache_hits: int
    cache_misses: int
    spec: ClusterSpec


def simulate(g: TaskGraph, sched: Schedule, spec: ClusterSpec, tm: TimeModel,
             cost: Optional[CostCache] = None) -> SimResult:
    """``cost`` optionally shares a memoized :class:`CostCache` (e.g. the one
    the scheduler already filled) so task durations are not re-derived from
    the interpolation polynomials task-by-task on large graphs."""
    if cost is None:
        cost = CostCache(tm, spec)
    prio = {tid: i for i, tid in enumerate(sched.order)}
    node_of = {tid: p.node for tid, p in sched.placements.items()}

    cache = NodeCache(spec.n_nodes)
    free_workers = {n: spec.workers_at(n) for n in range(spec.n_nodes)}
    free_slots = {n: list(range(spec.workers_at(n)))
                  for n in range(spec.n_nodes)}
    free_comm = {n: spec.comm_procs(n) for n in range(spec.n_nodes)}

    deps_left = {t.tid: len(t.preds) for t in g}
    # (key, dst) -> list of task ids waiting for that arrival
    waiting_data: Dict[Tuple[Tuple[int, int], int], List[int]] = defaultdict(list)
    data_left = {t.tid: 0 for t in g}
    ready: Dict[int, List[Tuple[int, int]]] = {n: [] for n in range(spec.n_nodes)}
    # startable transfers as a priority heap; a transfer blocked on an
    # exhausted comm endpoint is PARKED on that node and only returns to the
    # heap when the node frees a slot — so dispatch never rescans the whole
    # pending set (the naive rescan is O(events x pending) on big graphs)
    pending_xfers: List[Tuple[int, int, Transfer]] = []  # (prio, seq, tr)
    parked_xfers: Dict[int, List[Tuple[int, int, Transfer]]] = \
        defaultdict(list)
    xseq = itertools.count()
    in_flight: Set[Tuple[Tuple[int, int], int]] = set()
    # relay plan for fan-out edges: (key, relay node) -> child nodes whose
    # hop starts when the relay's own copy lands (same deterministic tree
    # shape as the executors' broadcast path, so tree depth is priced)
    relay_children: Dict[Tuple[Tuple[int, int], int], List[int]] = {}
    relay_prio: Dict[Tuple[Tuple[int, int], int], int] = {}

    events: List[Tuple[float, int, str, object]] = []
    seq = itertools.count()
    intervals: List[Interval] = []
    transfers_done: List[Transfer] = []
    now = 0.0

    def push(t, kind, payload):
        heapq.heappush(events, (t, next(seq), kind, payload))

    def task_ready(tid: int):
        n = node_of[tid]
        heapq.heappush(ready[n], (prio[tid], tid))

    def finish_producer(tid: int):
        """Producer done: release deps, create transfers for cross-node data."""
        t = g.tasks[tid]
        src = node_of[tid]
        if t.out is not None:
            cache.put(src, (tid, t.out.tensor))
        new_dsts: List[Tuple[int, int, Tuple]] = []   # (dst, nbytes, key)
        for s in sorted(t.succs, key=lambda x: prio[x]):
            st = g.tasks[s]
            nbytes = edge_bytes(g, t, st)
            dst = node_of[s]
            if nbytes and dst != src:
                key = (tid, t.out.tensor)
                if cache.peek(dst, key):
                    cache.hits += 1
                else:
                    data_left[s] += 1
                    waiting_data[(key, dst)].append(s)
                    if (key, dst) not in in_flight:
                        cache.misses += 1
                        in_flight.add((key, dst))
                        # succs iterate in prio order -> first waiter is
                        # the most urgent consumer at this destination
                        relay_prio[(key, dst)] = prio[s]
                        new_dsts.append((dst, nbytes, key))
            deps_left[s] -= 1
            if deps_left[s] == 0 and data_left[s] == 0:
                task_ready(s)
        if not new_dsts:
            return
        if len(new_dsts) >= BCAST_MIN_FANOUT:
            # fan-out edge: relay tree instead of N unicasts — only the
            # root's hops start now; deeper hops start as relays land
            key = new_dsts[0][2]
            nbytes = new_dsts[0][1]
            tree = broadcast_tree(src, [d for d, _, _ in new_dsts])
            for parent, kids in tree.items():
                if parent != src:
                    relay_children[(key, parent)] = kids
            for child in tree.get(src, []):
                heapq.heappush(
                    pending_xfers,
                    (relay_prio[(key, child)], next(xseq),
                     Transfer(key, src, child, nbytes)))
        else:
            for dst, nbytes, key in new_dsts:
                heapq.heappush(
                    pending_xfers,
                    (relay_prio[(key, dst)], next(xseq),
                     Transfer(key, src, dst, nbytes)))

    def dispatch(now: float):
        # start feasible transfers in priority order.  Starting a transfer
        # only CONSUMES comm slots, so a blocked transfer stays blocked for
        # the rest of this dispatch: it parks on its exhausted endpoint and
        # is only reconsidered once that node frees a slot.  Candidates are
        # k-way-merged in global priority order from the fresh-transfer heap
        # and the parked heaps of nodes that currently have free slots —
        # exactly the feasible subset the naive full rescan would start, at
        # O(starts + moves) instead of O(pending) per event.
        while True:
            best = pending_xfers[0] if pending_xfers else None
            best_node = -1
            for n, h in parked_xfers.items():
                if h and free_comm[n] > 0 and \
                        (best is None or h[0] < best):
                    best = h[0]
                    best_node = n
            if best is None:
                break
            src_heap = pending_xfers if best_node < 0 \
                else parked_xfers[best_node]
            item = heapq.heappop(src_heap)
            tr = item[2]
            if free_comm[tr.src] <= 0:
                heapq.heappush(parked_xfers[tr.src], item)
                continue
            if free_comm[tr.dst] <= 0:
                heapq.heappush(parked_xfers[tr.dst], item)
                continue
            free_comm[tr.src] -= 1
            free_comm[tr.dst] -= 1
            tr.start = now
            # per-edge codec-aware pricing (degrades to spec.comm_time
            # while the TimeModel's codec priors are unfitted)
            tr.end = now + tm.wire_time(tr.nbytes, tr.src, tr.dst, spec)
            push(tr.end, "xfer_done", tr)
        # start ready compute tasks
        for n in range(spec.n_nodes):
            while ready[n]:
                _, tid = ready[n][0]
                t = g.tasks[tid]
                if t.kind is TaskKind.CALLOC:
                    heapq.heappop(ready[n])
                    # CALLOC is async (§3.3): no worker slot occupied
                    dur = 1e-6
                    intervals.append(Interval(tid, t.kind.value, n, -1,
                                              now, now + dur))
                    push(now + dur, "task_done", tid)
                    continue
                if free_workers[n] <= 0:
                    break
                heapq.heappop(ready[n])
                free_workers[n] -= 1
                slot = free_slots[n].pop()
                dur = cost.time(t, n)
                intervals.append(Interval(tid, t.kind.value, n, slot,
                                          now, now + dur))
                push(now + dur, "task_done", (tid, slot))

    # seed: source tasks are immediately ready
    for t in g.sources():
        task_ready(t.tid)
    dispatch(0.0)

    while events:
        now, _, kind, payload = heapq.heappop(events)
        if kind == "task_done":
            if isinstance(payload, tuple):
                tid, slot = payload
                n = node_of[tid]
                free_workers[n] += 1
                free_slots[n].append(slot)
            else:
                tid = payload
            finish_producer(tid)
        elif kind == "xfer_done":
            tr: Transfer = payload
            free_comm[tr.src] += 1
            free_comm[tr.dst] += 1
            cache.put(tr.dst, tr.key)
            transfers_done.append(tr)
            in_flight.discard((tr.key, tr.dst))
            for s in waiting_data.pop((tr.key, tr.dst), []):
                data_left[s] -= 1
                if deps_left[s] == 0 and data_left[s] == 0:
                    task_ready(s)
            # the landed copy relays onward to its broadcast children
            for child in relay_children.pop((tr.key, tr.dst), []):
                heapq.heappush(
                    pending_xfers,
                    (relay_prio.get((tr.key, child), 0), next(xseq),
                     Transfer(tr.key, tr.dst, child, tr.nbytes)))
        dispatch(now)

    makespan = max((iv.end for iv in intervals), default=0.0)
    return SimResult(makespan, intervals, transfers_done,
                     cache.hits, cache.misses, spec)
