"""Wave-batched executor: one stacked call per wave group, on one device.

The per-task executor (``exec/local.py``) pays one Python dispatch per tile
task — and on a card, one kernel launch per task.  This backend batches:

1. the scheduled task graph is partitioned into **waves** — antichains of
   mutually independent tasks (longest-path levels, so every dependency
   crosses waves);
2. each wave is grouped by ``(kind, tile shape, dtype, payload class)``;
3. each group executes as ONE stacked call — a batched ``torch.matmul`` for
   ADDMUL (``backend="torch"``) or one launch of the hand-written CUDA
   kernel over the whole group (``backend="cuda"``, ``kernels/ops.
   addmul_batched``), one elementwise torch op over a stacked slab for
   ADD/SUB/EWMUL/SCALE/EWISE, ``fusion.eval_fused`` over stacked inputs for
   FUSED.

Buffer arena: every group's output tiles live in ONE device slab
``(group, tm, tn)``; each tile buffer is a view ``slab[i]``.  When a later
group's inputs are exactly a contiguous run of a slab, the gather is a
zero-copy slice (the common case for elementwise chains and the
C-accumulator of addmul k-chains); otherwise tiles are stacked into a
scratch copy.  Slabs are reference-counted: a slab is dropped when the
last reader of its last live tile finishes.

Numerics: ``backend="cuda"`` runs every ADDMUL tile through the same kernel
with the same block shape as the per-task ``kernel`` executor, and cuts a
long epilogue the same way (``kernels/ops.addmul_fused``), so the two agree
bitwise.  An integer product on a CUDA device takes the kernel path with
either backend: torch has no CUDA integer matmul, and the kernel
accumulates integers exactly in int64.  ``precision="mixed"`` casts A and
B to f32, accumulates in f32 and stores epilogue outputs as bf16
(validated at 2e-2).

``predict_wave_makespan`` is the executor-strategy leg of the paper's
simulation-driven selection: the engine compares it against the per-task
simulated makespan and picks the cheaper strategy per plan.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..core.fusion import eval_fused
from ..core.graph import (Task, TaskGraph, TaskKind, TileRef,
                          matmul_epilogue, matmul_flags)
from ..core.lazy import (EWISE_FNS, Op, apply_scale, card_integer_product,
                         leaf_slice, promoted_matmul)
from ..core.machine import ClusterSpec
from ..core.timemodel import CostCache, TimeModel
from ..core.tiling import assemble, tile_slices
from ..device import resolve_device
from ..runtime.telemetry import Tracer


def build_waves(g: TaskGraph) -> List[List[int]]:
    """Partition ``g`` into dependency levels (waves).

    ``wave[t] = 1 + max(wave[p] for p in preds)`` — tasks in one wave are
    mutually independent, so a wave can execute as a set of batched kernels
    with no intra-wave ordering.  Within a wave, tasks are ordered by output
    tile ``(tensor, i, j)`` so group gathers line up with slab layout.
    """
    level: Dict[int, int] = {}
    for t in g.topo():
        level[t.tid] = 1 + max((level[p] for p in t.preds), default=-1)
    n_waves = max(level.values(), default=-1) + 1
    waves: List[List[int]] = [[] for _ in range(n_waves)]
    for tid, lv in level.items():
        waves[lv].append(tid)

    def order_key(tid: int):
        t = g.tasks[tid]
        if t.out is not None:
            return (0, t.out.tensor, t.out.i, t.out.j, tid)
        return (1, 0, 0, 0, tid)

    for wave in waves:
        wave.sort(key=order_key)
    return waves


def _group_key(t: Task, dtypes: Dict[int, torch.dtype]) -> tuple:
    """Batching signature: tasks with equal keys stack into one call."""
    dt = lambda ref: str(dtypes.get(ref.tensor, torch.float64))  # noqa: E731
    k = t.kind
    if k is TaskKind.ADDMUL:
        key = (k, matmul_flags(t.payload), t.ins[0].shape, t.ins[1].shape,
               t.out.shape, dt(t.ins[0]), dt(t.ins[1]), dt(t.out))
        epi = matmul_epilogue(t.payload)
        if epi is not None:
            # epilogued chain tails batch separately from plain chain
            # steps: the stacked epilogue needs matching programs and
            # matching extra-operand shapes/dtypes across the group
            key += (epi, tuple(r.shape for r in t.ins[2:]),
                    tuple(dt(r) for r in t.ins[2:]))
        return key
    if k in (TaskKind.CALLOC, TaskKind.FILL):
        return (k, t.out.shape, dt(t.out))
    if k in (TaskKind.ADD, TaskKind.SUB, TaskKind.EWMUL):
        return (k, t.out.shape, dt(t.ins[0]), dt(t.ins[1]))
    if k in (TaskKind.SCALE, TaskKind.EWISE):
        return (k, t.payload, t.out.shape, dt(t.ins[0]))
    if k is TaskKind.FUSED:
        return (k, t.payload, tuple(r.shape for r in t.ins),
                tuple(dt(r) for r in t.ins))
    if k is TaskKind.TRANSPOSE:
        return (k, t.ins[0].shape, dt(t.ins[0]))
    if k is TaskKind.TAKECOPY:
        return (k,)
    raise ValueError(k)  # pragma: no cover


def group_wave(g: TaskGraph, wave: Sequence[int],
               dtypes: Dict[int, torch.dtype]
               ) -> List[Tuple[tuple, List[Task]]]:
    """Group one wave's tasks by batching signature (insertion-ordered)."""
    groups: Dict[tuple, List[Task]] = {}
    for tid in wave:
        t = g.tasks[tid]
        groups.setdefault(_group_key(t, dtypes), []).append(t)
    return list(groups.items())


class _Slab:
    """One stacked device allocation holding a wave group's output tiles."""

    __slots__ = ("arr", "live", "nbytes")

    def __init__(self, arr: torch.Tensor, live: int):
        self.arr = arr
        self.live = live
        self.nbytes = arr.element_size() * arr.numel()


class WaveArena:
    """Stacked tile storage with slab-granular refcounted freeing."""

    def __init__(self):
        #: TileRef -> (slab, index within slab)
        self._of: Dict[TileRef, Tuple[_Slab, int]] = {}
        self.cur_bytes = 0
        self.peak_bytes = 0
        self.slabs_alloc = 0
        self.slabs_freed = 0

    def register(self, refs: Sequence[TileRef], arr: torch.Tensor) -> _Slab:
        """Adopt ``arr`` (leading axis = tiles in ``refs`` order) as a slab.

        A ref holds exactly ONE slab slot alive at a time: re-registering
        (an epilogued chain tail rebinding its C tile) releases the
        previous hold.
        """
        slab = _Slab(arr, live=len(refs))
        self.cur_bytes += slab.nbytes
        self.peak_bytes = max(self.peak_bytes, self.cur_bytes)
        self.slabs_alloc += 1
        for i, r in enumerate(refs):
            if r in self._of:
                self.release_tile(r)
            self._of[r] = (slab, i)
        return slab

    def contiguous_run(self, refs: Sequence[TileRef]
                       ) -> Optional[torch.Tensor]:
        """Zero-copy stacked view if ``refs`` are one ascending slab run."""
        first = self._of.get(refs[0])
        if first is None:
            return None
        slab, start = first
        for k, r in enumerate(refs[1:], 1):
            ent = self._of.get(r)
            if ent is None or ent[0] is not slab or ent[1] != start + k:
                return None
        return slab.arr[start:start + len(refs)]

    def release_tile(self, ref: TileRef) -> bool:
        """Drop one live count of the tile's slab; True if the slab died."""
        ent = self._of.get(ref)
        if ent is None:
            return False
        slab, _ = ent
        slab.live -= 1
        if slab.live == 0:
            self.cur_bytes -= slab.nbytes
            self.slabs_freed += 1
            slab.arr = None
            return True
        return False


class WaveExecutor:
    """Executes a planned tiled program wave-by-wave with batched calls.

    ``backend="torch"`` (default) issues stacked torch ops;
    ``backend="cuda"`` routes ADDMUL groups through one launch of the
    hand-written CUDA kernel per group (epilogue included).
    """

    def __init__(self, backend: str = "torch", precision: str = "strict",
                 device=None):
        if backend not in ("torch", "cuda"):
            raise ValueError(f"unknown wave backend {backend!r}")
        if precision not in ("strict", "mixed"):
            raise ValueError(f"unknown precision mode {precision!r}")
        self.backend = backend
        #: ``"strict"`` (default) computes in the expression dtypes.
        #: ``"mixed"`` is the opt-in numerics gate: matmul accumulators
        #: CALLOC in float32, operands are cast to float32 for the
        #: multiply, and epilogued chain outputs are stored as bfloat16 —
        #: validated by tolerance (2e-2), never bitwise.
        self.precision = precision
        self.device = resolve_device(device)
        #: flight recorder: one EXEC span per batched group call (node 0,
        #: lane 0 — waves are sequential in this process)
        self.spans: List = []
        self.stats: Dict[str, int] = {}

    # -- gather helpers ----------------------------------------------------
    def _gather(self, refs, buffers, arena) -> torch.Tensor:
        if len(refs) == 1:
            self.stats["zero_copy_gathers"] += 1
            return buffers[refs[0]][None]
        run = arena.contiguous_run(refs)
        if run is not None and run.shape[0] == len(refs):
            self.stats["zero_copy_gathers"] += 1
            return run
        self.stats["copied_gathers"] += 1
        return torch.stack([buffers[r] for r in refs])

    @staticmethod
    def _bind(tasks, slab, buffers, arena) -> None:
        arena.register([t.out for t in tasks], slab)
        for i, t in enumerate(tasks):
            buffers[t.out] = slab[i]

    # -- group kernels -----------------------------------------------------
    def _run_group(self, kind: TaskKind, tasks: List[Task], buffers, arena,
                   leaf_nodes, dtypes, tile) -> None:
        self.stats["batched_calls"] += 1
        if kind is TaskKind.TAKECOPY:
            return
        if kind is TaskKind.CALLOC:
            dt = dtypes[tasks[0].payload]
            if self.precision == "mixed":
                # CALLOCs are matmul accumulators: f32 accumulate
                dt = torch.float32
            slab = torch.zeros((len(tasks),) + tasks[0].out.shape, dtype=dt,
                               device=self.device)
            self._bind(tasks, slab, buffers, arena)
            return
        if kind is TaskKind.FILL:
            self._run_fill(tasks, buffers, arena, leaf_nodes, tile)
            return
        if kind is TaskKind.ADDMUL:
            self._run_addmul(tasks, buffers, arena)
            return

        # elementwise families: one vectorized call over stacked operands
        ins0 = self._gather([t.ins[0] for t in tasks], buffers, arena)
        if kind in (TaskKind.ADD, TaskKind.SUB, TaskKind.EWMUL):
            ins1 = self._gather([t.ins[1] for t in tasks], buffers, arena)
            op = {TaskKind.ADD: torch.add, TaskKind.SUB: torch.sub,
                  TaskKind.EWMUL: torch.mul}[kind]
            slab = op(ins0, ins1)
        elif kind is TaskKind.SCALE:
            skind, s = tasks[0].payload
            slab = apply_scale(skind, ins0, s)
        elif kind is TaskKind.EWISE:
            slab = EWISE_FNS[tasks[0].payload](ins0)
        elif kind is TaskKind.FUSED:
            stacks = [self._gather([t.ins[j] for t in tasks], buffers, arena)
                      for j in range(len(tasks[0].ins))]
            slab = eval_fused(tasks[0].payload, stacks)
        elif kind is TaskKind.TRANSPOSE:
            slab = ins0.transpose(1, 2).contiguous()
        else:  # pragma: no cover
            raise ValueError(kind)
        self._bind(tasks, slab, buffers, arena)

    def _run_fill(self, tasks, buffers, arena, leaf_nodes, tile) -> None:
        def bounds(t):
            n = leaf_nodes[t.payload]
            rs = tile_slices(n.shape[0], tile[0])[t.out.i]
            cs = tile_slices(n.shape[1], tile[1])[t.out.j]
            return n, rs[0], rs[1], cs[0], cs[1]

        if all(leaf_nodes[t.payload].op is Op.INPUT
               and leaf_nodes[t.payload].payload.device == self.device
               for t in tasks):
            # zero-copy views into the user tensor, exactly like exec/local
            for t in tasks:
                buffers[t.out] = leaf_slice(*bounds(t), self.device)
            return
        node = leaf_nodes[tasks[0].payload]
        slab = torch.empty((len(tasks),) + tasks[0].out.shape,
                           dtype=node.dtype, device=self.device)
        for i, t in enumerate(tasks):
            slab[i] = leaf_slice(*bounds(t), self.device)
        self._bind(tasks, slab, buffers, arena)

    def _epilogue_store_dtype(self) -> Optional[torch.dtype]:
        return torch.bfloat16 if self.precision == "mixed" else None

    def _run_addmul(self, tasks, buffers, arena) -> None:
        """ADDMUL group: C += A @ B into the CALLOC'd tiles; the chain's
        tail group also applies its epilogue and rebinds the outputs."""
        ta, tb = matmul_flags(tasks[0].payload)
        epi = matmul_epilogue(tasks[0].payload)
        a3 = self._gather([t.ins[0] for t in tasks], buffers, arena)
        b3 = self._gather([t.ins[1] for t in tasks], buffers, arena)
        if ta:
            a3 = a3.transpose(1, 2)
        if tb:
            b3 = b3.transpose(1, 2)
        if self.precision == "mixed":
            a3 = a3.float()
            b3 = b3.float()
        stacks = [self._gather([t.ins[j] for t in tasks], buffers, arena)
                  for j in range(2, len(tasks[0].ins))]
        outs = [t.out for t in tasks]
        crun = arena.contiguous_run(outs) if len(outs) > 1 else None

        if self.backend == "cuda" or card_integer_product(a3, b3):
            from ..kernels import ops as kops
            c3 = crun if crun is not None else \
                torch.stack([buffers[t.out] for t in tasks])
            if epi is not None:
                # true fused kernel: accumulator -> epilogue -> store
                slab = kops.addmul_fused(
                    c3, a3, b3, epilogue=epi, extras=stacks,
                    out_dtype=self._epilogue_store_dtype(), batched=True)
                self._bind(tasks, slab, buffers, arena)
            elif crun is not None:
                kops.addmul_batched(c3, a3, b3, out=crun)
            else:
                out = kops.addmul_batched(c3, a3, b3)
                for i, t in enumerate(tasks):
                    buffers[t.out].copy_(out[i])
            return

        prod = promoted_matmul(a3, b3)
        if crun is not None:
            crun += prod
        else:
            for i, t in enumerate(tasks):
                buffers[t.out] += prod[i]
        if epi is not None:
            # tail of the k-chain: the fused epilogue over the
            # fully-accumulated C tiles in one stacked pass
            c3 = crun if crun is not None else \
                torch.stack([buffers[t.out] for t in tasks])
            slab = eval_fused(epi, [c3] + stacks)
            store_dt = self._epilogue_store_dtype()
            if store_dt is not None:
                slab = slab.to(store_dt)
            self._bind(tasks, slab, buffers, arena)

    # -- execution loop ----------------------------------------------------
    def execute(self, plan):
        g: TaskGraph = plan.program.graph
        tile = plan.tile
        leaf_nodes = plan.program.leaf_nodes
        dtypes = plan.program.dtypes
        rsets = plan.program.result_sets
        waves = plan.waves or build_waves(g)

        buffers: Dict[TileRef, torch.Tensor] = {}
        arena = WaveArena()
        self.stats = {"zero_copy_gathers": 0, "copied_gathers": 0,
                      "batched_calls": 0}

        # readers per tile (+1 keeps result tiles alive for assembly)
        refcnt: Dict[TileRef, int] = {}
        for t in g:
            for r in t.ins:
                refcnt[r] = refcnt.get(r, 0) + 1
        for rs in rsets:
            for r in rs.tiles:
                refcnt[r] = refcnt.get(r, 0) + 1
        # an ADDMUL chain rewrites its C tile: every chain step after the
        # slab's CALLOC holds the tile alive even though it is not in `ins`
        for t in g:
            if t.kind is TaskKind.ADDMUL:
                refcnt[t.out] = refcnt.get(t.out, 0) + 1

        tracer = Tracer()
        tasks_run = 0
        for wi, wave in enumerate(waves):
            for (key, tasks) in group_wave(g, wave, dtypes):
                with tracer.span(key[0].name, cat="EXEC", wave=wi,
                                 tasks=len(tasks), batched=True):
                    self._run_group(key[0], tasks, buffers, arena,
                                    leaf_nodes, dtypes, tile)
                tasks_run += len(tasks)
                for t in tasks:
                    reads = list(t.ins)
                    if t.kind is TaskKind.ADDMUL:
                        reads.append(t.out)   # release the chain's hold
                    for r in reads:
                        refcnt[r] -= 1
                        if refcnt[r] == 0:
                            # result tiles hold an extra assembly ref, so
                            # they can never reach zero here
                            arena.release_tile(r)
                            buffers.pop(r, None)

        outs = []
        for rs in rsets:
            vals = {r: buffers[r] for r in rs.tiles}
            outs.append(assemble(vals, rs.shape, tile, rs.uid))

        self.spans = tracer.drain()
        self.stats.update({
            "peak_buffer_bytes": arena.peak_bytes,
            "cur_buffer_bytes": arena.cur_bytes,
            "slabs_alloc": arena.slabs_alloc,
            "buffers_freed": arena.slabs_freed,
            "tasks_run": tasks_run,
            "waves": len(waves),
        })
        return outs[0] if len(outs) == 1 else outs


def predict_wave_makespan(g: TaskGraph, spec: ClusterSpec, tm: TimeModel,
                          waves: Optional[List[List[int]]] = None,
                          dtypes: Optional[Dict[int, torch.dtype]] = None,
                          cost: Optional[CostCache] = None) -> float:
    """Predicted wall-clock of wave-batched execution under ``tm``.

    Waves run back-to-back; each group costs one
    ``tm.batch_dispatch_overhead`` plus its summed per-slice kernel time
    spread over the node's worker parallelism.  Compare with the per-task
    simulated makespan — which pays ``tm.dispatch_overhead`` per task — to
    pick an executor strategy.
    """
    waves = waves or build_waves(g)
    dtypes = dtypes or {}
    cost = cost or CostCache(tm, spec)
    # the wave executor runs in ONE process: its parallelism is the widest
    # node's worker count
    par = max(1, max(spec.workers_at(n) for n in range(spec.n_nodes)))
    total = 0.0
    for wave in waves:
        for (key, tasks) in group_wave(g, wave, dtypes):
            kind = key[0]
            if kind is TaskKind.TAKECOPY:
                continue
            if kind is TaskKind.CALLOC:
                total += 1e-6      # calloc slab: near-free
                continue
            kern = sum(cost.kernel(t) for t in tasks)
            total += tm.batch_dispatch_overhead + kern / par
    return total
