"""Tiled task-dependency graph (CMM §3.1–3.2), transcribed from the JAX
reference (``repro.core.graph``) so both packages build identical graphs.

Task classification follows the paper exactly:

* ``calloc``  — allocation + zero-init of an output tile (paper merged
  malloc+fillzero into one async calloc task, §3.3);
* ``fill``    — materialise an input tile (data fill, scheduled just before
  first use, §3.3);
* ``addmul``  — tiled GEMM-accumulate ``C_ij += A_ik @ B_kj`` (the hot task);
* ``sub``     — tiled subtraction (paper's ``sub!``); add/ewise/scale kept as
  separate kinds with the same cost-model family;
* ``takecopy``— copy a result tile from its worker to the master node;
* ``send``/``recv`` — communication tasks, created by the scheduler when an
  edge crosses nodes (they are not part of the logical DAG).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple


class TaskKind(enum.Enum):
    CALLOC = "calloc"
    FILL = "fill"
    ADDMUL = "addmul"
    MATMUL = "matmul"      # first k-step of an accumulate chain (C = A@B)
    ADD = "add"
    SUB = "sub"
    EWMUL = "ewmul"
    SCALE = "scale"
    EWISE = "ewise"
    TRANSPOSE = "transpose"
    FUSED = "fused"        # fused elementwise region: one task per tile
    TAKECOPY = "takecopy"
    SEND = "send"
    RECV = "recv"


#: kinds that do arithmetic (appear in the compute time model)
COMPUTE_KINDS = {
    TaskKind.ADDMUL, TaskKind.MATMUL, TaskKind.ADD, TaskKind.SUB,
    TaskKind.EWMUL, TaskKind.SCALE, TaskKind.EWISE, TaskKind.TRANSPOSE,
    TaskKind.FUSED,
}


def matmul_flags(payload) -> Tuple[bool, bool]:
    """Transposed-operand flags carried by ADDMUL/MATMUL tasks (the fusion
    optimizer folds ``A.T @ B`` into flags instead of a TRANSPOSE pass).

    Understands both the bare ``(ta, tb)`` form and the epilogue-carrying
    ``("epi", (ta, tb), prog)`` form (see :func:`epilogue_payload`)."""
    if (isinstance(payload, tuple) and len(payload) == 3
            and payload[0] == "epi"):
        payload = payload[1]
    if (isinstance(payload, tuple) and len(payload) == 2
            and all(isinstance(x, bool) for x in payload)):
        return payload
    return (False, False)


def matmul_epilogue(payload) -> Optional[tuple]:
    """The fused elementwise epilogue program attached to an ADDMUL/MATMUL
    (``None`` when the task is a plain GEMM-accumulate).

    The program reuses the FUSED tile-program encoding (``core.fusion``):
    input slot 0 is the fully accumulated ``C`` tile, slots ``1..`` are the
    task's extra operand tiles ``ins[2:]`` in order.  The executor applies
    it once, after the last k-step of the accumulate chain."""
    if (isinstance(payload, tuple) and len(payload) == 3
            and payload[0] == "epi"):
        return payload[2]
    return None


def epilogue_payload(flags: Optional[Tuple[bool, bool]],
                     prog: tuple) -> tuple:
    """Build the tagged MATMUL/ADDMUL payload carrying a fused epilogue:
    ``("epi", (ta, tb), prog)`` — hashable, so CSE / plan-cache keys and
    the wave executor's group signatures work unchanged."""
    ta, tb = matmul_flags(flags)
    return ("epi", (ta, tb), tuple(prog))


@dataclass(frozen=True)
class TileRef:
    """Identity of one tile of one logical tensor.

    ``tensor`` is the ClusteredMatrix uid (or a synthesised uid for
    intermediates); ``(i, j)`` the tile grid coordinate; ``shape`` the actual
    tile shape (edge tiles may be ragged, Listing 1 uses ``min`` bounds).
    """

    tensor: int
    i: int
    j: int
    shape: Tuple[int, int]

    @property
    def bytes(self) -> int:
        return self.shape[0] * self.shape[1] * 8  # f64 default accounting

    def __repr__(self):
        return f"T{self.tensor}[{self.i},{self.j}]{self.shape}"


@dataclass
class Task:
    tid: int
    kind: TaskKind
    #: input tiles (data operands); order matters (addmul: A_ik, B_kj)
    ins: Tuple[TileRef, ...]
    #: output tile
    out: Optional[TileRef]
    #: op-specific payload (ewise fn name, scale (kind, s), leaf node uid…)
    payload: object = None
    preds: Set[int] = field(default_factory=set)
    succs: Set[int] = field(default_factory=set)
    #: floating point ops (for the time model / GFLOPS accounting)
    flops: int = 0

    def dims(self) -> Tuple[int, ...]:
        """Operand dims fed to the Table-1 interpolation equations."""
        if self.kind in (TaskKind.ADDMUL, TaskKind.MATMUL):
            ta, tb = matmul_flags(self.payload)
            sa, sb = self.ins[0].shape, self.ins[1].shape
            m, n = (sa[1], sa[0]) if ta else sa
            k = sb[0] if tb else sb[1]
            return (m, n, k)
        shp = (self.out.shape if self.out is not None else self.ins[0].shape)
        return shp

    def __repr__(self):
        return (f"Task#{self.tid}:{self.kind.value}"
                f"({','.join(map(repr, self.ins))})->{self.out}")


class TaskGraph:
    """A DAG of tiled tasks with dependency edges."""

    def __init__(self):
        self.tasks: Dict[int, Task] = {}
        self._next = 0

    # -- construction ------------------------------------------------------
    def add(self, kind: TaskKind, ins: Sequence[TileRef],
            out: Optional[TileRef], payload=None, flops: int = 0,
            deps: Iterable[int] = ()) -> Task:
        t = Task(self._next, kind, tuple(ins), out, payload, flops=flops)
        self._next += 1
        self.tasks[t.tid] = t
        for d in deps:
            self.add_edge(d, t.tid)
        return t

    def add_edge(self, u: int, v: int):
        if u == v:
            raise ValueError("self-edge")
        self.tasks[u].succs.add(v)
        self.tasks[v].preds.add(u)

    # -- queries -------------------------------------------------------------
    def __len__(self):
        return len(self.tasks)

    def __iter__(self):
        return iter(self.tasks.values())

    def sources(self) -> List[Task]:
        return [t for t in self.tasks.values() if not t.preds]

    def topo(self) -> List[Task]:
        """Kahn topological order; raises on cycles."""
        indeg = {tid: len(t.preds) for tid, t in self.tasks.items()}
        ready = sorted(tid for tid, d in indeg.items() if d == 0)
        out: List[Task] = []
        import heapq
        heapq.heapify(ready)
        while ready:
            tid = heapq.heappop(ready)
            out.append(self.tasks[tid])
            for s in sorted(self.tasks[tid].succs):
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(out) != len(self.tasks):
            raise ValueError("task graph has a cycle")
        return out

    def validate(self):
        """Structural invariants (used by property tests)."""
        for t in self.tasks.values():
            for p in t.preds:
                assert t.tid in self.tasks[p].succs, "edge asymmetry"
            for s in t.succs:
                assert t.tid in self.tasks[s].preds, "edge asymmetry"
            if t.kind in (TaskKind.ADDMUL, TaskKind.MATMUL):
                ta, tb = matmul_flags(t.payload)
                sa = t.ins[0].shape[::-1] if ta else t.ins[0].shape
                sb = t.ins[1].shape[::-1] if tb else t.ins[1].shape
                assert sa[1] == sb[0], f"inner dim mismatch in {t}"
                assert t.out.shape == (sa[0], sb[1]), \
                    f"out shape mismatch in {t}"
                if matmul_epilogue(t.payload) is not None:
                    # epilogue extras are elementwise operands of the
                    # accumulated C tile — same shape by construction
                    for r in t.ins[2:]:
                        assert r.shape == t.out.shape, \
                            f"epilogue extra shape mismatch in {t}"
                else:
                    assert len(t.ins) == 2, \
                        f"extra ins without an epilogue in {t}"
        self.topo()  # raises on cycle
