"""Cache-aware modified HEFT scheduler (CMM §3.6).

Two phases, as in the original HEFT:

1. *Ranking* — tasks are recursively ranked by upward rank
   ``rank_u(t) = w_avg(t) + max_succ (c_avg(t, s) + rank_u(s))`` using the
   profiled time model for ``w`` and the per-pair link model for ``c``.
2. *Placement* — in decreasing rank order, each task is assigned to the
   (node, worker-process) slot with the earliest finish time, with an
   insertion policy over per-slot busy intervals.

CMM modifications implemented here:

* **node-level cache** (§3.5): the communication cost of an edge is zero when
  the consumer's node already holds that tile version; the cache is updated
  *during* scheduling, so later placement decisions see earlier transfers.
* **per-pair connection speeds** (§3.4): comm costs come from
  ``spec.bandwidth(a, b)``.
* **pinning**: ``takecopy`` runs on the master; ``fill`` of user-supplied
  (INPUT) data originates on the master (the initial master->worker comm
  phase visible in Fig. 3); generated data (RANDOM/ZEROS/EYE) fills locally
  on whichever node the scheduler picks (§3.3 optimisation).
* ``calloc`` is free-placed and cheap (async in the engine; §3.3).

Task compute times are memoized per unique ``(kind, operand-dims,
payload-class, node)`` signature (``timemodel.CostCache``), and each
worker-slot timeline stores its *free gaps* so the insertion policy bisects
instead of scanning every placed task.  This is the JAX reference's fast
planning path (``repro.core.heft``), transcribed so that both packages
place every task on the same slot at the same start time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence

from .cache import NodeCache
from .graph import Task, TaskGraph, TaskKind
from .machine import ClusterSpec
from .timemodel import CostCache, TimeModel


@dataclass
class Placement:
    node: int
    slot: int
    start: float
    finish: float


@dataclass
class CommEvent:
    """A cross-node transfer committed during scheduling."""

    src_task: int
    dst_task: int
    src: int
    dst: int
    nbytes: int
    cached: bool  # True -> satisfied by node-level cache (no transfer)


@dataclass
class Schedule:
    placements: Dict[int, Placement]
    order: List[int]                      # rank order (scheduling priority)
    comms: List[CommEvent]
    makespan: float
    cache_hits: int
    cache_misses: int


def edge_bytes(g: TaskGraph, u: Task, v: Task) -> int:
    """Bytes flowing along dependency edge u->v.

    u's output tile is data for v if v reads it (in ``v.ins``) or if v
    accumulates into the same tile (addmul chains share ``out``).  Pure
    ordering edges carry no data.
    """
    if u.out is None:
        return 0
    if u.out in v.ins:
        return u.out.bytes
    if v.out is not None and u.out == v.out:
        return u.out.bytes
    return 0


def _avg_comm(nbytes: int, spec: ClusterSpec,
              tm: Optional[TimeModel] = None) -> float:
    if spec.n_nodes <= 1 or nbytes == 0:
        return 0.0
    frac = (spec.n_nodes - 1) / spec.n_nodes
    dst = 1 if spec.n_nodes > 1 else 0
    if tm is not None:
        # codec-aware edge pricing (identical to spec.comm_time while the
        # TimeModel's compression priors are unfitted)
        return frac * tm.wire_time(nbytes, 0, dst, spec)
    return frac * spec.comm_time(nbytes, 0, dst)


def upward_rank(g: TaskGraph, spec: ClusterSpec, tm: TimeModel,
                cost=None) -> Dict[int, float]:
    """Upward ranks under ``tm``.

    ``cost`` (a :class:`~repro_torch.core.timemodel.CostCache`) supplies
    ``avg(task)``, memoized per unique task signature.
    """
    cost = cost if cost is not None else CostCache(tm, spec)
    rank: Dict[int, float] = {}
    w: Dict[int, float] = {}
    for t in g:
        if t.kind is TaskKind.CALLOC:
            w[t.tid] = 1e-6  # async, near-free (§3.3)
        else:
            w[t.tid] = cost.avg(t)
    comm_memo: Dict[int, float] = {}
    for t in reversed(g.topo()):
        best = 0.0
        for s in t.succs:
            st = g.tasks[s]
            nb = edge_bytes(g, t, st)
            c = comm_memo.get(nb)
            if c is None:
                c = _avg_comm(nb, spec, tm)
                comm_memo[nb] = c
            cr = c + rank[s]
            if cr > best:
                best = cr
        rank[t.tid] = w[t.tid] + best
    return rank


class _GapTimeline:
    """One worker slot stored as its FREE gaps plus the free tail.

    Queries bisect into the (short, sorted) gap list instead of scanning
    every placed interval, and tail appends are O(1).
    """

    __slots__ = ("gs", "ge", "tail")

    def __init__(self):
        #: parallel sorted arrays: free gap i is [gs[i], ge[i]), all < tail
        self.gs: List[float] = []
        self.ge: List[float] = []
        #: everything from here on is free
        self.tail = 0.0

    def earliest(self, ready: float, dur: float) -> float:
        import bisect
        ge = self.ge
        i = bisect.bisect_right(ge, ready)   # first gap ending after `ready`
        gs = self.gs
        for i in range(i, len(gs)):
            t = gs[i] if gs[i] >= ready else ready
            if t + dur <= ge[i]:
                return t
        return self.tail if self.tail >= ready else ready

    def insert(self, start: float, dur: float):
        import bisect
        end = start + dur
        if start >= self.tail:
            if start > self.tail:
                self.gs.append(self.tail)
                self.ge.append(start)
            self.tail = end
            return
        i = bisect.bisect_right(self.gs, start) - 1
        if i < 0 or end > self.ge[i]:
            raise ValueError(
                f"insert [{start}, {end}) overlaps busy time")
        gs, ge = self.gs[i], self.ge[i]
        if gs < start and end < ge:          # split the gap in two
            self.gs[i:i + 1] = [gs, end]
            self.ge[i:i + 1] = [start, ge]
        elif gs < start:                     # trim the gap's tail
            self.ge[i] = start
        elif end < ge:                       # trim the gap's head
            self.gs[i] = end
        else:                                # exact fill
            del self.gs[i]
            del self.ge[i]


def heft_schedule(g: TaskGraph, spec: ClusterSpec, tm: TimeModel,
                  fill_origin: Optional[Mapping[int, str]] = None,
                  cost: Optional[CostCache] = None) -> Schedule:
    """Schedule ``g`` on ``spec`` under time model ``tm``.

    The schedule is cache-aware: a transfer a node has already received is
    not priced again (the node-level-cache modification of HEFT).

    Fills are lazy, the paper's §3.3 optimisation: data fills
    of *generated* inputs are NOT ranked/placed independently; a fill is
    placed on the node of its first-scheduled consumer, just before that
    consumer runs.  Later consumers on other nodes pay the normal
    (cache-aware) transfer.

    ``fill_origin`` maps leaf expression-node uid -> ``"master"`` |
    ``"local"`` (INPUT leaves live on the master; generated leaves fill in
    place).  ``cost`` lets the caller share one :class:`CostCache` across
    scheduling and simulation.
    """
    origin = fill_origin or {}
    if cost is None:
        cost = CostCache(tm, spec)
    rank = upward_rank(g, spec, tm, cost=cost)
    cache = NodeCache(spec.n_nodes)

    def is_lazy(t: Task) -> bool:
        if t.kind is not TaskKind.FILL:
            return False
        return origin.get(t.payload) != "master"   # master INPUT stays pinned

    order_all = sorted(g.tasks, key=lambda tid: (-rank[tid], tid))
    order = [tid for tid in order_all if not is_lazy(g.tasks[tid])]

    slots = {n: [_GapTimeline() for _ in range(spec.workers_at(n))]
             for n in range(spec.n_nodes)}
    placements: Dict[int, Placement] = {}
    comms: List[CommEvent] = []

    #: drained nodes (0 worker slots — evicted by the elastic runtime)
    #: never receive placements
    live_nodes = spec.alive_nodes()
    if not live_nodes:
        raise ValueError("cluster spec has no live nodes to schedule on")
    if spec.master not in live_nodes:
        raise ValueError("the master node is drained; cannot schedule")

    def allowed_nodes(t: Task) -> Sequence[int]:
        if t.kind is TaskKind.TAKECOPY:
            return (spec.master,)
        if t.kind is TaskKind.FILL and isinstance(t.payload, int):
            if origin.get(t.payload) == "master":
                return (spec.master,)
        return live_nodes

    #: node -> {fill duration: estimated EFT}; a fill EFT estimate only
    #: changes when the node's timelines change, and a wave of consumers
    #: probes the same few fill durations over and over
    fill_est: Dict[int, Dict[float, float]] = \
        {n: {} for n in range(spec.n_nodes)}

    def commit(tid: int, node: int, si: int, st: float, eft: float,
               transfers) -> None:
        t = g.tasks[tid]
        slots[node][si].insert(st, eft - st)
        fill_est[node].clear()
        placements[tid] = Placement(node, si, st, eft)
        for (p, src, nbytes, hit) in transfers:
            key = (p, g.tasks[p].out.tensor)
            comms.append(CommEvent(p, tid, src, node, nbytes, hit))
            if hit:
                cache.hits += 1
            else:
                cache.misses += 1
                cache.put(node, key)
        if t.out is not None:
            cache.put(node, (tid, t.out.tensor))

    def place_fill_on(fid: int, node: int) -> float:
        """Place a lazy fill on `node` at its earliest slot; returns EFT."""
        ft = g.tasks[fid]
        dur = cost.time(ft, node)
        best = None
        for si, sl in enumerate(slots[node]):
            st = sl.earliest(0.0, dur)
            if best is None or st + dur < best[0]:
                best = (st + dur, si, st)
        eft, si, st = best
        commit(fid, node, si, st, eft, [])
        return eft

    def fill_eft_estimate(fid: int, node: int) -> float:
        ft = g.tasks[fid]
        dur = cost.time(ft, node)
        est = fill_est[node].get(dur)
        if est is None:
            est = min(sl.earliest(0.0, dur) + dur for sl in slots[node])
            fill_est[node][dur] = est
        return est

    def eval_on_node(t: Task, node: int, dur: float):
        """(eft, slot, start, transfers, lazy_fills, regen_fills)."""
        ready = 0.0
        transfers = []
        lazy_here = []
        regen_here = []
        for p in t.preds:
            pt = g.tasks[p]
            if p not in placements:
                # unplaced lazy fill: generated locally on this node
                assert is_lazy(pt), f"unplaced non-lazy pred {pt}"
                arr = fill_eft_estimate(p, node)
                lazy_here.append(p)
                ready = max(ready, arr)
                continue
            pp = placements[p]
            nbytes = edge_bytes(g, pt, t)
            arr = pp.finish
            if nbytes and pp.node != node:
                key = (p, pt.out.tensor)
                hit = cache.peek(node, key)
                if not hit:
                    # codec-aware per-edge pricing
                    arr_x = pp.finish + tm.wire_time(nbytes, pp.node,
                                                     node, spec)
                    if is_lazy(pt):
                        # generated data is a pure function of (seed, tile):
                        # regenerating locally can beat transferring
                        # (§3.3 local initialisation)
                        arr_r = fill_eft_estimate(p, node)
                        if arr_r < arr_x:
                            regen_here.append(p)
                            ready = max(ready, arr_r)
                            continue
                    arr = arr_x
                transfers.append((p, pp.node, nbytes, hit))
            ready = max(ready, arr)
        best = None
        for si, sl in enumerate(slots[node]):
            st = sl.earliest(ready, dur)
            if best is None or st + dur < best[0]:
                best = (st + dur, si, st)
        eft, si, st = best
        return eft, si, st, transfers, lazy_here, regen_here

    for tid in order:
        t = g.tasks[tid]

        best = None  # (eft, node, dur)
        for node in allowed_nodes(t):
            dur = 1e-6 if t.kind is TaskKind.CALLOC else cost.time(t, node)
            eft, *_ = eval_on_node(t, node, dur)
            if best is None or eft < best[0] - 1e-15 or \
                    (abs(eft - best[0]) <= 1e-15 and node < best[1]):
                best = (eft, node, dur)

        _, node, dur = best
        # commit this node: place lazy/regenerated fills FIRST, then
        # re-evaluate so the consumer's slot fit sees the fills' intervals
        _, _, _, _, lazy_here, regen_here = eval_on_node(t, node, dur)
        for fid in lazy_here:
            place_fill_on(fid, node)
        for fid in regen_here:
            ft = g.tasks[fid]
            clone = g.add(TaskKind.FILL, (), ft.out, payload=ft.payload)
            g.tasks[fid].succs.discard(tid)
            t.preds.discard(fid)
            g.add_edge(clone.tid, tid)
            place_fill_on(clone.tid, node)
        eft, si, st, transfers, lazy2, regen2 = eval_on_node(t, node, dur)
        assert not lazy2 and not regen2
        commit(tid, node, si, st, eft, transfers)

    # any fill no consumer reached (dead code in the expression) — place it
    for tid in order_all:
        if tid not in placements:
            place_fill_on(tid, spec.master)

    final_order = sorted(placements, key=lambda x: (placements[x].start, x))
    makespan = max((p.finish for p in placements.values()), default=0.0)
    return Schedule(placements, final_order, comms, makespan,
                    cache.hits, cache.misses)
