"""Time-prediction model (CMM §3.4, Table 1).

Each task kind has an interpolation equation — a multivariate polynomial in
the operand dimensions — whose coefficients are fitted by ordinary least
squares on offline-profiled timings:

    (n,1)  op (n,1)   +,-,x      a0 + a1*n
    (m,n)      sin,cos           a0 + a1*n + a2*m + a3*m*n
    (m,n)  op scalar  +,-,x,/    a0 + a1*n + a2*m + a3*m*n
    (m,n)  op (m,n)   +,-,x      a0 + a1*n + a2*m + a3*m*n
    (m,n)  x  (n,k)              a0 + a1*m + a2*n + a3*k + a4*mn + a5*nk
                                    + a6*mk + a7*mnk

Communication time is modelled per node pair: latency + bytes / pair
bandwidth (the paper's §3.4 fix after the one-worker-only pathology).

Transcribed from the JAX reference (``repro.core.timemodel``): the same
``to_json`` text loads in either package and prices every task the same.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from .graph import Task, TaskKind, matmul_epilogue
from .machine import ClusterSpec


def features_ewise(dims: Sequence[int]) -> np.ndarray:
    m, n = dims
    return np.array([1.0, n, m, m * n])


def features_matmul(dims: Sequence[int]) -> np.ndarray:
    m, n, k = dims
    return np.array([1.0, m, n, k, m * n, n * k, m * k, m * n * k])


FEATURES = {
    "ewise": features_ewise,    # all (m,n)-shaped kinds
    "matmul": features_matmul,  # (m,n)x(n,k) kinds
}

#: task kind -> feature family
KIND_FAMILY = {
    TaskKind.ADDMUL: "matmul",
    TaskKind.MATMUL: "matmul",
    TaskKind.ADD: "ewise",
    TaskKind.SUB: "ewise",
    TaskKind.EWMUL: "ewise",
    TaskKind.SCALE: "ewise",
    TaskKind.EWISE: "ewise",
    TaskKind.TRANSPOSE: "ewise",
    TaskKind.FUSED: "ewise",
    TaskKind.CALLOC: "ewise",
    TaskKind.FILL: "ewise",
    TaskKind.TAKECOPY: "ewise",
}


@dataclass
class PolyModel:
    """One fitted interpolation equation."""

    family: str
    coef: np.ndarray

    def predict(self, dims: Sequence[int]) -> float:
        # NOTE: planning deliberately evaluates this SCALAR path (memoized
        # per unique signature in CostCache) rather than a stacked matvec —
        # BLAS matvec rounding differs from per-row dot in the last ulp,
        # which would break the bit-identical fast/slow-schedule invariant.
        x = FEATURES[self.family](dims)
        return float(max(x @ self.coef, 1e-9))


@dataclass
class TimeModel:
    """Per-kind compute models + the per-pair communication model."""

    models: Dict[str, PolyModel] = field(default_factory=dict)
    #: per-task scheduling/dispatch overhead, seconds (heap pop, closure,
    #: lock round-trip per submitted task — fitted by
    #: ``profiler.calibrate_dispatch``)
    dispatch_overhead: float = 0.0
    #: per-*batched-kernel-launch* overhead, seconds: one stacked call
    #: issued by the wave executor pays this ONCE per group instead of
    #: ``dispatch_overhead`` once per task (fitted by
    #: ``profiler.calibrate_batch_dispatch``)
    batch_dispatch_overhead: float = 1e-4
    #: throughput scale observed under concurrent workers (profiling times
    #: one call at a time; real execution oversubscribes BLAS threads on a
    #: shared host — fitted by ``profiler.calibrate_contention``)
    contention: float = 1.0
    #: per-task overhead of the multi-process cluster executor, seconds:
    #: one dispatch-queue round trip (pickle, pipe write, wakeup, ack) per
    #: task instead of the in-process ``dispatch_overhead`` — fitted by
    #: ``profiler.calibrate_ipc``
    process_dispatch_overhead: float = 5e-4
    #: shared-memory inter-process tile-copy throughput, bytes/s (the
    #: ClusterExecutor's XFER cost is ``ipc_latency + bytes/ipc_bandwidth``
    #: instead of the network link model — fitted by
    #: ``profiler.calibrate_ipc``)
    ipc_bandwidth: float = 2e9
    #: per-XFER message latency of the cluster executor, seconds
    ipc_latency: float = 2e-4
    #: mean time between failures of one (non-master) node, seconds — the
    #: churn model the elastic runtime prices ``auto`` selection with
    #: (``simulator.churn_adjusted_makespan``).  ``inf`` = assume a
    #: pristine cluster (the static executors' implicit assumption).
    node_mtbf: float = float("inf")
    #: fixed wall-clock cost of one recovery event, seconds: failure
    #: detection (heartbeat patience) + frontier re-plan + respawn/rewire
    respawn_overhead: float = 0.5
    #: sequential disk read bandwidth for reloading checkpointed tiles,
    #: bytes/s — prices the reload-from-disk leg of the durable session's
    #: restore path (``simulator.predict_reload_seconds``) against
    #: lineage recompute
    spill_read_bandwidth: float = 1e9
    #: sequential disk write bandwidth for evicting tiles from a bounded
    #: arena to the spill tier, bytes/s — prices out-of-core execution
    #: (``simulator.predict_spill_seconds``) so the engine's admission
    #: check can *choose* spilling over rejection
    spill_write_bandwidth: float = 1e9
    #: fixed steady-state cost one asynchronous tile snapshot adds to the
    #: session path, seconds (the writer handoff — the host-side copy is
    #: priced separately at ``spill_read_bandwidth`` and the disk write
    #: itself overlaps the next compute)
    checkpoint_write_overhead: float = 1e-3
    #: wire-codec encode throughput, bytes of *raw* tile per second
    #: (``runtime.wire`` zlib path — fitted by
    #: ``profiler.calibrate_compression``).  ``0`` = codec unprofiled/
    #: disabled: per-edge pricing always chooses ``"raw"`` and the
    #: transfer path is byte-for-byte the pre-codec one.
    compress_bandwidth: float = 0.0
    #: expected raw/compressed size ratio of a typical tile payload under
    #: the wire codec (data-dependent; fitted on a structured probe tile
    #: by ``calibrate_compression``).  ``1.0`` = assume incompressible.
    compression_ratio_prior: float = 1.0

    def _model_time(self, task: Task) -> float:
        """Raw interpolation-model prediction for one task (no contention,
        dispatch, or node slowdown applied)."""
        kind = task.kind
        if kind in (TaskKind.SEND, TaskKind.RECV):
            raise ValueError("comm tasks are costed by wire_time()")
        family = KIND_FAMILY[kind]
        model = self.models.get(kind.value) or self.models.get(family)
        if model is None:
            # analytic fallback: ~1 GFLOP/s effective if unprofiled
            flops = max(task.flops, int(np.prod(task.dims())))
            return flops / 1e9
        t = model.predict(task.dims())
        if kind is TaskKind.FUSED:
            # a fused region does N elementwise passes' arithmetic in
            # one task (with better locality; the single-pass model
            # per op is a conservative upper bound)
            from .fusion import fused_op_count
            t *= max(1, fused_op_count(task.payload))
        elif kind in (TaskKind.ADDMUL, TaskKind.MATMUL):
            t += self._epilogue_time(task)
        return t

    def _epilogue_time(self, task: Task) -> float:
        """Extra arithmetic of a fused matmul epilogue: N elementwise
        passes over the output tile, priced with the ewise-family model
        (same accounting a standalone FUSED task would get)."""
        epi = matmul_epilogue(task.payload)
        if epi is None:
            return 0.0
        from .fusion import fused_flops, fused_op_count
        m, n, k = task.dims()
        shape = (m, k)                       # the output tile
        em = self.models.get(TaskKind.FUSED.value) or self.models.get("ewise")
        if em is None:
            return fused_flops(epi, *shape) / 1e9
        return max(1, fused_op_count(epi)) * em.predict(shape)

    def kernel_time(self, task: Task, spec: Optional[ClusterSpec] = None,
                    node: int = 0) -> float:
        """Pure arithmetic time of ``task`` — NO per-task dispatch overhead.

        This is what one slice of a batched (stacked) kernel call costs; the
        wave executor's cost model sums it per group and adds
        ``batch_dispatch_overhead`` once per launch.
        """
        t = self._model_time(task) * self.contention
        if spec is not None:
            t *= spec.node_slowdown(node)
        return t

    def compute_time(self, task: Task, spec: Optional[ClusterSpec] = None,
                     node: int = 0) -> float:
        """Per-task execution time as the per-task executor pays it:
        arithmetic + one dispatch overhead."""
        t = self._model_time(task) * self.contention + self.dispatch_overhead
        if spec is not None:
            t *= spec.node_slowdown(node)
        return t

    def wire_time(self, nbytes: int, src: int, dst: int,
                  spec: ClusterSpec) -> float:
        """Codec-aware edge time: ``min(raw, compress_cpu + compressed
        transfer)`` under the fitted codec priors.  Degrades exactly to
        ``spec.comm_time`` while the priors are unfitted, so schedules
        and simulations are unchanged by default."""
        base = spec.comm_time(nbytes, src, dst)
        if (src == dst or nbytes <= 0 or self.compress_bandwidth <= 0.0
                or self.compression_ratio_prior <= 1.0):
            return base
        comp = (nbytes / self.compress_bandwidth
                + spec.comm_time(int(nbytes / self.compression_ratio_prior),
                                 src, dst))
        return min(base, comp)

    # -- (de)serialisation --------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "dispatch_overhead": self.dispatch_overhead,
            "batch_dispatch_overhead": self.batch_dispatch_overhead,
            "contention": self.contention,
            "process_dispatch_overhead": self.process_dispatch_overhead,
            "ipc_bandwidth": self.ipc_bandwidth,
            "ipc_latency": self.ipc_latency,
            # json emits inf as the (non-standard but round-tripping)
            # Infinity literal; keep it explicit for readability
            "node_mtbf": self.node_mtbf,
            "respawn_overhead": self.respawn_overhead,
            "spill_read_bandwidth": self.spill_read_bandwidth,
            "spill_write_bandwidth": self.spill_write_bandwidth,
            "checkpoint_write_overhead": self.checkpoint_write_overhead,
            "compress_bandwidth": self.compress_bandwidth,
            "compression_ratio_prior": self.compression_ratio_prior,
            "models": {k: {"family": m.family, "coef": m.coef.tolist()}
                       for k, m in self.models.items()},
        })

    @staticmethod
    def from_json(s: str) -> "TimeModel":
        d = json.loads(s)
        return TimeModel(
            models={k: PolyModel(v["family"], np.asarray(v["coef"]))
                    for k, v in d["models"].items()},
            dispatch_overhead=d.get("dispatch_overhead", 0.0),
            batch_dispatch_overhead=d.get("batch_dispatch_overhead", 1e-4),
            contention=d.get("contention", 1.0),
            process_dispatch_overhead=d.get("process_dispatch_overhead",
                                            5e-4),
            ipc_bandwidth=d.get("ipc_bandwidth", 2e9),
            ipc_latency=d.get("ipc_latency", 2e-4),
            node_mtbf=d.get("node_mtbf", float("inf")),
            respawn_overhead=d.get("respawn_overhead", 0.5),
            spill_read_bandwidth=d.get("spill_read_bandwidth", 1e9),
            spill_write_bandwidth=d.get("spill_write_bandwidth", 1e9),
            checkpoint_write_overhead=d.get("checkpoint_write_overhead",
                                            1e-3),
            compress_bandwidth=d.get("compress_bandwidth", 0.0),
            compression_ratio_prior=d.get("compression_ratio_prior", 1.0),
        )


class CostCache:
    """Memoized task compute times for one ``(TimeModel, ClusterSpec)`` pair.

    Planning a 100k-task graph evaluates the interpolation polynomials
    O(tasks x nodes) times, but a tiled program has only a handful of
    distinct ``(kind, operand dims, payload class)`` signatures — one per
    tile shape per kind.  The cache collapses the polynomial evaluations to
    one per unique ``(signature, node)``, which is what makes the HEFT fast
    path scale (§3.6 planning at 100k tasks).

    Predictions are computed with the *scalar* ``PolyModel.predict`` so a
    cached cost is bit-identical to the uncached path — fast and slow
    planning produce identical schedules.
    """

    __slots__ = ("tm", "spec", "_time", "_kernel", "_avg")

    def __init__(self, tm: "TimeModel", spec: Optional[ClusterSpec] = None):
        self.tm = tm
        self.spec = spec
        self._time: Dict[tuple, float] = {}
        self._kernel: Dict[tuple, float] = {}
        self._avg: Dict[tuple, float] = {}

    @staticmethod
    def signature(task: Task) -> tuple:
        extra = None
        if task.kind is TaskKind.FUSED:
            from .fusion import fused_op_count
            extra = fused_op_count(task.payload)
        elif task.kind in (TaskKind.ADDMUL, TaskKind.MATMUL):
            epi = matmul_epilogue(task.payload)
            if epi is not None:
                # the pricing reads the op count (fitted-model path) and
                # the per-element flop weight (analytic fallback); key on
                # both so cached and uncached predictions always agree
                from .fusion import fused_flops, fused_op_count
                extra = ("epi", fused_op_count(epi), fused_flops(epi, 1, 1))
        return (task.kind, task.dims(), extra)

    def time(self, task: Task, node: int = 0) -> float:
        """Memoized ``tm.compute_time(task, spec, node)``."""
        key = (self.signature(task), node)
        v = self._time.get(key)
        if v is None:
            v = self.tm.compute_time(task, self.spec, node)
            self._time[key] = v
        return v

    def kernel(self, task: Task, node: int = 0) -> float:
        """Memoized ``tm.kernel_time(task, spec, node)``."""
        key = (self.signature(task), node)
        v = self._kernel.get(key)
        if v is None:
            v = self.tm.kernel_time(task, self.spec, node)
            self._kernel[key] = v
        return v

    def avg(self, task: Task) -> float:
        """Memoized average compute time over all nodes (upward-rank ``w``).

        Reproduces the exact summation order of the unmemoized
        ``sum(costs) / len(costs)`` loop so ranks are bit-identical.
        """
        sig = self.signature(task)
        v = self._avg.get(sig)
        if v is None:
            n = self.spec.n_nodes if self.spec is not None else 1
            costs = [self.time(task, i) for i in range(n)]
            v = sum(costs) / len(costs)
            self._avg[sig] = v
        return v


def analytic_time_model(gflops: float = 5.5, mem_gbs: float = 10.0,
                        base_us: float = 30.0) -> TimeModel:
    """A synthetic time model from machine constants (no profiling).

    Matches the paper's observed ~5.5 GFLOPS/worker-process plateau (Table 2).
    Used when offline profiles are unavailable (e.g. pure-simulation tests).
    """
    tm = TimeModel()
    a0 = base_us * 1e-6
    # matmul: time = flops / rate -> coefficient only on the mnk term
    c = np.zeros(8)
    c[0] = a0
    c[7] = 2.0 / (gflops * 1e9)
    tm.models["matmul"] = PolyModel("matmul", c)
    # ewise family: bandwidth-bound, 8 B/elem in + 8 out
    e = np.zeros(4)
    e[0] = a0
    e[3] = 16.0 / (mem_gbs * 1e9)
    tm.models["ewise"] = PolyModel("ewise", e)
    return tm
