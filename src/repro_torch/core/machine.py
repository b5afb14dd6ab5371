"""Cluster machine model (CMM §4.1–4.2), transcribed from the JAX reference
(``repro.core.machine``).

The paper's ideal configuration per c5.9xlarge node: 3 worker processes
(4 BLAS threads each), 2 communication processes on workers, more on the
master; 10 Gbps shared network.  These are *model* parameters — the HEFT
scheduler and the discrete-event simulator consume them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple


@dataclass(frozen=True)
class ClusterSpec:
    n_nodes: int = 1
    #: compute slots per node (paper: 3 worker processes x 4 BLAS threads)
    worker_procs: int = 3
    threads_per_worker: int = 4
    #: dedicated communication processes (paper: master gets more, §3.6)
    comm_procs_worker: int = 2
    comm_procs_master: int = 4
    #: link bandwidth, bytes/s (c5.9xlarge: 10 Gbps guaranteed)
    link_bw: float = 10e9 / 8
    #: per-message latency, s
    latency: float = 200e-6
    #: per-pair bandwidth overrides {(a,b): bytes/s} — the paper's fix of
    #: modelling *connection speeds between two nodes* (§3.4)
    pair_bw: Tuple[Tuple[Tuple[int, int], float], ...] = ()
    #: master node index
    master: int = 0
    #: per-node compute slowdown factors (straggler modelling, runtime/fault)
    slowdown: Tuple[float, ...] = ()
    #: per-node worker-process overrides (heterogeneous clusters: unequal
    #: slot counts per node).  Empty -> every node gets ``worker_procs``.
    node_workers: Tuple[int, ...] = ()

    def comm_procs(self, node: int) -> int:
        return self.comm_procs_master if node == self.master \
            else self.comm_procs_worker

    def workers_at(self, node: int) -> int:
        """Compute slots on ``node`` (heterogeneous-aware); a zero entry
        means the node is drained and takes no placements."""
        if self.node_workers and node < len(self.node_workers):
            return max(0, self.node_workers[node])
        return self.worker_procs

    def total_workers(self) -> int:
        return sum(self.workers_at(n) for n in range(self.n_nodes))

    def alive_nodes(self) -> Tuple[int, ...]:
        """Nodes that still hold compute slots (not drained)."""
        return tuple(n for n in range(self.n_nodes)
                     if self.workers_at(n) > 0)

    def bandwidth(self, a: int, b: int) -> float:
        for (pa, pb), bw in self.pair_bw:
            if (pa, pb) == (a, b) or (pa, pb) == (b, a):
                return bw
        return self.link_bw

    def node_slowdown(self, node: int) -> float:
        if self.slowdown and node < len(self.slowdown):
            return self.slowdown[node]
        return 1.0

    def comm_time(self, nbytes: int, a: int, b: int) -> float:
        if a == b:
            return 0.0
        return self.latency + nbytes / self.bandwidth(a, b)


def c5_9xlarge(n_nodes: int = 1, **kw) -> ClusterSpec:
    """The paper's AWS instance: 36 vCPU / 18 physical cores, 10 Gbps."""
    return ClusterSpec(n_nodes=n_nodes, **kw)


def hetero_spec(node_workers: Sequence[int],
                slowdown: Sequence[float] = (), **kw) -> ClusterSpec:
    """A heterogeneous cluster: one node per entry of ``node_workers`` with
    that many worker processes, optionally per-node compute slowdowns —
    the spec shape the multi-process ClusterExecutor exercises."""
    return ClusterSpec(n_nodes=len(node_workers),
                       node_workers=tuple(int(w) for w in node_workers),
                       slowdown=tuple(float(s) for s in slowdown), **kw)
