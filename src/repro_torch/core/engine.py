"""CMM engine: expression -> optimize -> tiled DAG -> HEFT -> sim -> run.

The user-facing orchestration layer (Fig. 1 of the paper), on one torch
device.  ``CMMEngine.run``

1. optimizes the expression DAG (``fusion.optimize_many``: CSE, identity
   folding, transpose-into-matmul folding, elementwise-chain fusion and
   matmul-epilogue fusion),
2. tiles the optimized expression (``tiling.tile_expression_many``),
3. schedules with cache-aware HEFT under the time model,
4. simulates the schedule (the check the paper runs before execution) and
   prices the wave-batched strategy beside it,
5. executes with an in-process executor from ``exec.EXECUTORS`` and returns
   the materialised tensor on the engine's device.

Repeated runs with the same *structure* hit a structural **plan cache**:
the tiled program + HEFT schedule are reused with the leaves rebound to the
new data, so planning is paid once per structure.  Planning is the JAX
reference's (``repro.core.engine``) step for step; the multi-process,
elastic, out-of-core and roofline strategies of the reference are not part
of this package yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from .fusion import (FusionReport, leaves_in_order_many, optimize_many,
                     structural_signature_many)
from .heft import Schedule, heft_schedule
from .lazy import ClusteredMatrix, Op, topo_order_many
from .machine import ClusterSpec, c5_9xlarge
from .simulator import SimResult, simulate
from .tiling import TiledProgram, normalize_tile, tile_expression_many
from .timemodel import CostCache, TimeModel, analytic_time_model
from ..device import resolve_device

#: tolerance of ``run(validate=True)`` against ``eager()``, by the coarser
#: dtype of the two results (the numerics tiers of TESTING.md)
VALIDATE_TOL = {torch.float64: 1e-8, torch.float32: 1e-4,
                torch.bfloat16: 2e-2}


def assert_tier_close(out: torch.Tensor, ref: torch.Tensor,
                      tol: Optional[float] = None) -> None:
    """Hold ``out`` to ``ref`` at ``tol``, by default the tier of the
    coarser of the two dtypes.

    f64 is elementwise at 1e-8 (the reference's ``validate``).  Below f64
    the absolute term scales with ``max|ref|``: a K-term dot product in
    f32 or bf16 carries error relative to the operands' scale, not to its
    own (possibly near-zero) value.
    """
    coarse = out.dtype if out.element_size() <= ref.element_size() \
        else ref.dtype
    if tol is None:
        tol = VALIDATE_TOL[coarse]
    scale = 1.0
    if coarse != torch.float64:
        scale = max(1.0, float(ref.abs().max()))
    torch.testing.assert_close(out.double(), ref.double(), rtol=tol,
                               atol=tol * scale)


@dataclass
class Plan:
    program: TiledProgram
    schedule: Schedule
    sim: SimResult
    tile: Tuple[int, int]
    plan_seconds: float
    spec: Optional[ClusterSpec] = None
    fusion: Optional[FusionReport] = None
    cache_hit: bool = False
    #: dependency levels of the task graph (wave-batched execution order)
    waves: Optional[list] = None
    #: predicted wall-clock of the wave-batched executor strategy
    batched_makespan: Optional[float] = None

    @property
    def best_executor(self) -> str:
        """``"local"`` or ``"batched"``, whichever is predicted faster."""
        if self.batched_makespan is not None and \
                self.batched_makespan < self.sim.makespan:
            return "batched"
        return "local"


class CMMEngine:
    def __init__(self, spec: Optional[ClusterSpec] = None,
                 timemodel: Optional[TimeModel] = None,
                 tile: Optional[int] = None,
                 plan_cache: bool = True,
                 device=None):
        self.spec = spec or c5_9xlarge(1)
        self.timemodel = timemodel or analytic_time_model()
        self.tile = tile
        self.plan_cache = plan_cache
        #: where executors run and ``validate`` evaluates the oracle
        #: (``None``: the CUDA card; raises if there is none)
        self.device = resolve_device(device)
        #: structural signature + tile -> cached Plan
        self._plans: Dict[tuple, Plan] = {}
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        #: flight recorder: spans + stats of the last ``execute_plan`` call
        self.last_spans: list = []
        self.last_exec_stats: Dict[str, object] = {}

    # -- planning -----------------------------------------------------------
    @staticmethod
    def _fill_origins(roots: Sequence[ClusteredMatrix]) -> Dict[int, str]:
        out = {}
        for node in topo_order_many(roots):
            if node.op is Op.INPUT:
                out[node.uid] = "master"     # user data lives on the master
            elif node.op in (Op.RANDOM, Op.ZEROS, Op.EYE):
                out[node.uid] = "local"      # generated in place (§3.3)
        return out

    def plan(self, root: ClusteredMatrix, tile=None) -> Plan:
        """Plan one root — a thin wrapper over :meth:`plan_many`."""
        return self.plan_many((root,), tile=tile)

    def plan_many(self, roots: Sequence[ClusteredMatrix], tile=None) -> Plan:
        """Plan a multi-root program with shared CSE.  The plan cache key
        covers the union structure, the tile, the spec and the TimeModel."""
        t0 = time.perf_counter()
        roots = list(roots)
        tile = normalize_tile(tile or self.tile or self._default_tile(roots))
        roots, report = optimize_many(roots)

        key = None
        if self.plan_cache:
            # the TimeModel fingerprint keys the cache too: a recalibrated
            # model must not replay schedules priced under the old one
            key = (structural_signature_many(roots), tile, self.spec,
                   self.timemodel.to_json())
            hit = self._plans.get(key)
            if hit is not None:
                self.plan_cache_hits += 1
                prog = hit.program.rebound(leaves_in_order_many(roots))
                return Plan(prog, hit.schedule, hit.sim, hit.tile,
                            time.perf_counter() - t0, spec=self.spec,
                            fusion=report, cache_hit=True, waves=hit.waves,
                            batched_makespan=hit.batched_makespan)
            self.plan_cache_misses += 1

        prog = tile_expression_many(roots, tile)
        # one cost object shared by scheduling, simulation and wave costing
        cost = CostCache(self.timemodel, self.spec)
        sched = heft_schedule(prog.graph, self.spec, self.timemodel,
                              fill_origin=self._fill_origins(roots),
                              cost=cost)
        sim = simulate(prog.graph, sched, self.spec, self.timemodel,
                       cost=cost)
        from ..exec.batched import build_waves, predict_wave_makespan
        waves = build_waves(prog.graph)
        batched = predict_wave_makespan(prog.graph, self.spec,
                                        self.timemodel, waves=waves,
                                        dtypes=prog.dtypes, cost=cost)
        plan = Plan(prog, sched, sim, tile, time.perf_counter() - t0,
                    spec=self.spec, fusion=report, waves=waves,
                    batched_makespan=batched)
        if key is not None:
            if len(self._plans) >= 128:      # bound cache growth (FIFO)
                self._plans.pop(next(iter(self._plans)))
            self._plans[key] = self._cache_copy(plan)
        return plan

    @staticmethod
    def _cache_copy(plan: Plan) -> Plan:
        """The cached entry must not pin user data: INPUT leaf payloads are
        dropped — a hit rebinds fresh leaves."""
        prog = plan.program
        stripped = []
        for uid in prog.leaf_order:
            n = prog.leaf_nodes[uid]
            if n.op is Op.INPUT:
                n = ClusteredMatrix(n.op, n.shape, n.dtype, payload=None,
                                    name=n.name)
            stripped.append(n)
        return Plan(prog.rebound(stripped), plan.schedule, plan.sim, plan.tile, plan.plan_seconds,
                    spec=plan.spec, waves=plan.waves,
                    batched_makespan=plan.batched_makespan)

    def _default_tile(self, roots: Sequence[ClusteredMatrix]) -> int:
        # paper finding: tile ~ n/2 is best for n=10k on 8 nodes (§3.3);
        # fall back to half the largest dimension.
        dim = max(max(n.shape) for n in topo_order_many(roots))
        return max(1, dim // 2)

    # -- execution ------------------------------------------------------------
    def run(self, root: ClusteredMatrix, tile=None, executor: str = "local",
            validate: bool = False, plan: Optional[Plan] = None,
            **exec_kw) -> torch.Tensor:
        """Plan (unless ``plan`` is given), execute through a backend of
        ``exec.EXECUTORS`` on the engine's device, and return the result:

        * ``"local"``        — per-task threaded executor, torch ops;
        * ``"kernel"``       — per-task, ADDMUL tiles through the CUDA kernel;
        * ``"batched"``      — wave-batched stacked torch ops;
        * ``"batched-cuda"`` — wave-batched, one CUDA kernel launch per
          ADDMUL group;
        * ``"auto"``         — the cheaper of the per-task and wave-batched
          strategies as the plan predicts them.

        ``validate=True`` holds the result to ``root.eager()`` on the same
        device (:func:`assert_tier_close`).
        """
        plan = plan or self.plan(root, tile=tile)
        out = self.execute_plan(plan, executor=executor, **exec_kw)
        if validate:
            assert_tier_close(out, root.eager(self.device))
        return out

    def execute_plan(self, plan: Plan, executor: str = "local", **exec_kw):
        """Execute a prepared plan with an executor built from the
        registry on the engine's device."""
        if executor == "auto":
            executor = self.choose_executor(plan)
        from ..exec import make_executor
        executor_obj = make_executor(executor, device=self.device, **exec_kw)
        out = executor_obj.execute(plan)
        self.last_exec_stats = dict(executor_obj.stats)
        self.last_exec_stats["executor"] = executor
        self.last_spans = list(executor_obj.spans)
        return out

    def choose_executor(self, plan: Plan) -> str:
        """Per-plan executor strategy from predicted makespans (§3.3's
        simulation-driven selection, extended to execution strategy)."""
        return plan.best_executor
