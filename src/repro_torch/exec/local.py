"""Local executor: runs a planned tiled task graph on one torch device.

Executes tasks in HEFT-priority order with a thread pool sized from the
plan's machine model (``ClusterSpec.total_workers()``).  Whatever HEFT
decided, the data dependencies enforced here must reproduce
``ClusteredMatrix.eager()``.

* FILL builds **only its own tile** on the device — INPUT tiles are views
  into the user tensor when it lies on the device, RANDOM tiles are drawn
  on the host from the canonical block RNG and copied over, ZEROS/EYE
  build just the tile.
* CALLOC allocates in the expression dtype (``TiledProgram.dtypes``).
* Buffers are reference-counted: a tile is dropped as soon as its last
  reader finishes, so peak memory is bounded by *live* tiles.
  ``self.stats`` records the observed peak.

``use_kernel=True`` routes ADDMUL tiles through the hand-written CUDA
kernel (``kernels/ops.addmul``: K1, or K2 when the task carries an
epilogue; ``ops.addmul_fused`` runs the part of a long epilogue the kernel
cannot hold in ``eval_fused``); otherwise they run as ``torch.matmul`` plus
``eval_fused``.  An integer product on a CUDA device takes the kernel path
in either mode: torch has no CUDA integer matmul, and the kernel
accumulates integers exactly in int64.

On a CUDA device the pool threads only enqueue work: every launch goes to
the device's current stream in the order the dependencies release it, so
no task synchronises with the card.
"""
from __future__ import annotations

import heapq
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from ..core.fusion import eval_fused
from ..core.graph import (Task, TaskGraph, TaskKind, TileRef,
                          matmul_epilogue, matmul_flags)
from ..core.lazy import (EWISE_FNS, apply_scale, card_integer_product,
                         leaf_slice, promoted_matmul)
from ..core.tiling import assemble, tile_slices
from ..device import resolve_device
from ..runtime.telemetry import Tracer


def tensor_nbytes(t: torch.Tensor) -> int:
    """Bytes a buffer owns: a view (``_base`` set: an INPUT leaf slice or a
    wave-slab member) owns none."""
    return 0 if t._base is not None else t.element_size() * t.numel()


class LocalExecutor:
    def __init__(self, use_kernel: bool = False, device=None):
        self.use_kernel = use_kernel
        self.device = resolve_device(device)
        #: flight recorder: EXEC spans per task (node 0, one lane per
        #: pool thread); ``spans`` holds the last run's timeline
        self.spans: list = []
        #: filled by execute(): peak_buffer_bytes, tasks_run, buffers_freed
        self.stats: Dict[str, int] = {}

    def execute(self, plan):
        g: TaskGraph = plan.program.graph
        tile = plan.tile
        leaf_nodes = plan.program.leaf_nodes
        dtypes = plan.program.dtypes
        rsets = plan.program.result_sets
        device = self.device
        buffers: Dict[TileRef, torch.Tensor] = {}

        # readers per tile buffer (+1 keeps every result tile alive for
        # final assembly); freed at zero by the last reader
        refcnt: Dict[TileRef, int] = {}
        for t in g:
            for r in t.ins:
                refcnt[r] = refcnt.get(r, 0) + 1
        for rs in rsets:
            for r in rs.tiles:
                refcnt[r] = refcnt.get(r, 0) + 1
        mem = {"cur": 0, "peak": 0, "freed": 0}
        #: bytes currently accounted per tile ref — a task that REBINDS
        #: ``buffers[t.out]`` over an earlier allocation must release the
        #: old allocation's bytes
        owned: Dict[TileRef, int] = {}

        from ..kernels import ops as kops

        def run_task(t: Task):
            if t.kind is TaskKind.CALLOC:
                buffers[t.out] = torch.zeros(t.out.shape,
                                             dtype=dtypes[t.payload],
                                             device=device)
                return
            if t.kind is TaskKind.FILL:
                node = leaf_nodes[t.payload]
                rs = tile_slices(node.shape[0], tile[0])[t.out.i]
                cs = tile_slices(node.shape[1], tile[1])[t.out.j]
                buffers[t.out] = leaf_slice(node, rs[0], rs[1], cs[0], cs[1],
                                            device)
                return
            if t.kind is TaskKind.ADDMUL:
                ta, tb = matmul_flags(t.payload)
                epi = matmul_epilogue(t.payload)
                a = buffers[t.ins[0]]
                b = buffers[t.ins[1]]
                a = a.T if ta else a
                b = b.T if tb else b
                c = buffers[t.out]
                extras = [buffers[r] for r in t.ins[2:]]
                if self.use_kernel or card_integer_product(a, b):
                    # chain steps accumulate into C in place; the epilogued
                    # tail stores its own (possibly promoted) tile
                    if epi is None:
                        kops.addmul(c, a, b, out=c)
                    else:
                        buffers[t.out] = kops.addmul_fused(
                            c, a, b, epilogue=epi, extras=extras)
                else:
                    c += promoted_matmul(a, b)
                    if epi is not None:
                        # last task of the k-chain: apply the fused
                        # elementwise epilogue over the accumulated tile
                        buffers[t.out] = eval_fused(epi, [c] + extras)
                return
            if t.kind is TaskKind.ADD:
                buffers[t.out] = buffers[t.ins[0]] + buffers[t.ins[1]]
                return
            if t.kind is TaskKind.SUB:
                buffers[t.out] = buffers[t.ins[0]] - buffers[t.ins[1]]
                return
            if t.kind is TaskKind.EWMUL:
                buffers[t.out] = buffers[t.ins[0]] * buffers[t.ins[1]]
                return
            if t.kind is TaskKind.SCALE:
                kind, s = t.payload
                buffers[t.out] = apply_scale(kind, buffers[t.ins[0]], s)
                return
            if t.kind is TaskKind.EWISE:
                buffers[t.out] = EWISE_FNS[t.payload](buffers[t.ins[0]])
                return
            if t.kind is TaskKind.FUSED:
                buffers[t.out] = eval_fused(
                    t.payload, [buffers[r] for r in t.ins])
                return
            if t.kind is TaskKind.TRANSPOSE:
                buffers[t.out] = buffers[t.ins[0]].T.contiguous()
                return
            if t.kind is TaskKind.TAKECOPY:
                # gather to master: locally a no-op (buffer already present)
                return
            raise ValueError(t.kind)  # pragma: no cover

        # dependency-driven execution in schedule priority order
        prio = {tid: i for i, tid in enumerate(plan.schedule.order)}
        deps_left = {t.tid: len(t.preds) for t in g}
        ready = [(prio[t.tid], t.tid) for t in g.sources()]
        heapq.heapify(ready)
        cv = threading.Condition(threading.Lock())
        inflight = [0]

        nworkers = max(1, plan.spec.total_workers())

        def account(t: Task):
            """Memory bookkeeping after a task ran (under cv)."""
            if t.out is not None and t.kind is not TaskKind.TAKECOPY:
                buf = buffers.get(t.out)
                if buf is not None:
                    new = tensor_nbytes(buf)
                    old = owned.get(t.out, 0)
                    if new != old:
                        mem["cur"] += new - old
                        if new:
                            owned[t.out] = new
                        else:
                            owned.pop(t.out, None)
                    mem["peak"] = max(mem["peak"], mem["cur"])
            for r in t.ins:
                refcnt[r] -= 1
                if refcnt[r] == 0:
                    buf = buffers.pop(r, None)
                    if buf is not None:
                        mem["cur"] -= owned.pop(r, 0)
                        mem["freed"] += 1

        def worker_done(tid: int):
            with cv:
                account(g.tasks[tid])
                for s in g.tasks[tid].succs:
                    deps_left[s] -= 1
                    if deps_left[s] == 0:
                        heapq.heappush(ready, (prio[s], s))
                inflight[0] -= 1
                cv.notify_all()

        errors: list = []
        tracer = Tracer()
        with ThreadPoolExecutor(max_workers=nworkers) as pool:
            submitted = 0
            total = len(g)
            with cv:
                while submitted < total and not errors:
                    while not ready and not errors:
                        cv.wait()
                    if errors:
                        break
                    _, tid = heapq.heappop(ready)
                    inflight[0] += 1
                    submitted += 1

                    def job(tid=tid):
                        try:
                            t = g.tasks[tid]
                            with tracer.span(t.kind.name, cat="EXEC",
                                             tid=tid, kind=t.kind.name):
                                run_task(t)
                        except BaseException as e:  # surface task failures
                            errors.append(e)
                        finally:
                            worker_done(tid)

                    pool.submit(job)
                while inflight[0] > 0:
                    cv.wait()
        if errors:
            raise errors[0]

        outs = []
        for rs in rsets:
            vals = {r: buffers[r] for r in rs.tiles}
            outs.append(assemble(vals, rs.shape, tile, rs.uid))

        self.spans = tracer.drain()
        self.stats = {"peak_buffer_bytes": mem["peak"],
                      "cur_buffer_bytes": mem["cur"],
                      "buffers_freed": mem["freed"],
                      "tasks_run": len(g),
                      "workers": nworkers}
        return outs[0] if len(outs) == 1 else outs
