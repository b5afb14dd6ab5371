"""Engine parity: ``repro_torch``'s ``CMMEngine.run`` against the JAX
reference's, executor by executor, on the CPU.

The port's executors run on ``device="cpu"`` here, so ``kernel`` and
``batched-cuda`` take their kernels' plain versions; the kernels themselves
are held to those on the card by ``chip_smoke.py``.  Tolerances are the
tiers of TESTING.md:

* f64: 1e-8 (torch and numpy reduce in different orders, never bitwise);
* the reference's Pallas paths compute in f32 under JAX's default x32, so
  ``kernel``/``batched-cuda`` are held to ``kernel``/``batched-pallas`` at
  the f32 tier, 1e-4 (relative to the result's largest entry);
* ``precision="mixed"``: 2e-2.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.core import CMMEngine as RefEngine
from repro.core import analytic_time_model
from repro.core.machine import hetero_spec
from repro_torch import convert, suite
from repro_torch.core import CMMEngine
from repro_torch.core.engine import assert_tier_close
from repro_torch.exec import EXECUTORS, make_executor
from repro_torch.kernels import matmul as mm

_spec = importlib.util.spec_from_file_location(
    "ref_cmm_suite", os.path.join(os.path.dirname(__file__), "..",
                                  "benchmarks", "cmm_suite.py"))
ref_suite = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_suite)

TM = analytic_time_model()
SPEC = hetero_spec((3, 2, 1), link_bw=1e12, latency=1e-6)


def _engines():
    ref = RefEngine(SPEC, TM, plan_cache=False)
    port = CMMEngine(convert.spec_from_fields(**dataclasses.asdict(SPEC)),
                     convert.timemodel_from_json(TM.to_json()),
                     plan_cache=False, device="cpu")
    return ref, port


def _close(got: torch.Tensor, want: np.ndarray, tol: float):
    """Elementwise at ``tol`` with the absolute term scaled by the
    result's largest entry (1 for f64, as in ``validate``)."""
    want_t = torch.from_numpy(np.asarray(want, np.float64))
    assert tuple(got.shape) == want_t.shape
    scale = 1.0 if tol <= 1e-8 else max(1.0, float(want_t.abs().max()))
    torch.testing.assert_close(got.double(), want_t, rtol=tol,
                               atol=tol * scale)


@pytest.mark.parametrize("tile", (24, 16))
@pytest.mark.parametrize("workload", sorted(suite.BENCHMARKS))
def test_suite_matches_reference_local(workload, tile):
    ref, port = _engines()
    want = ref.run(ref_suite.BENCHMARKS[workload](48), tile=tile,
                   executor="local")
    expr = suite.BENCHMARKS[workload](48)
    plan = port.plan(expr, tile=tile)
    for ex in ("local", "batched", "kernel", "batched-cuda"):
        got = port.run(expr, executor=ex, plan=plan)
        assert got.dtype == torch.float64, ex
        _close(got, want, 1e-8)
    # the port's own oracle agrees too (run(validate=True) on the CPU)
    port.run(expr, executor="local", plan=plan, validate=True)


@pytest.mark.parametrize("workload", ["Kmeans", "Synth", "Leontief", "Hits"])
def test_kernel_paths_match_reference_pallas(workload):
    """``kernel`` vs ``kernel`` and ``batched-cuda`` vs ``batched-pallas``
    (the reference's Pallas kernels in interpret mode)."""
    ref, port = _engines()
    n, tile = 32, 16
    ref_plan = ref.plan(ref_suite.BENCHMARKS[workload](n), tile=tile)
    expr = suite.BENCHMARKS[workload](n)
    plan = port.plan(expr, tile=tile)
    for ours, theirs in (("kernel", "kernel"),
                         ("batched-cuda", "batched-pallas")):
        want = ref.execute_plan(ref_plan, executor=theirs)
        _close(port.run(expr, executor=ours, plan=plan), want, 1e-4)


@pytest.mark.parametrize("executor,ref_executor", [
    ("batched", "batched"), ("batched-cuda", "batched-pallas")])
@pytest.mark.parametrize("workload", ["Kmeans", "Synth"])
def test_mixed_precision_matches_reference(workload, executor, ref_executor):
    ref, port = _engines()
    n, tile = 32, 16
    want = ref.run(ref_suite.BENCHMARKS[workload](n), tile=tile,
                   executor=ref_executor, precision="mixed")
    expr = suite.BENCHMARKS[workload](n)
    got = port.run(expr, tile=tile, executor=executor, precision="mixed")
    assert got.dtype == {"float32": torch.float32,
                         "bfloat16": torch.bfloat16}[
        np.asarray(want).dtype.name]
    _close(got, np.asarray(want, np.float64), 2e-2)
    strict = port.run(expr, tile=tile, executor=executor)
    assert_tier_close(got, strict, tol=2e-2)


def test_f32_expression_matches_reference():
    ref, port = _engines()
    want = ref.run(ref_suite.BENCHMARKS["Hill"](48), tile=16)
    for ex in ("local", "batched"):
        x = suite.hill(48, dtype=torch.float32)
        got = port.run(x, tile=16, executor=ex)
        assert got.dtype == torch.float32
        _close(got, want, 1e-4)


# -- guards ---------------------------------------------------------------------

def test_default_device_is_the_card_never_a_fallback():
    """``device=None`` means CUDA: without a card the engine and every
    executor raise instead of running on the CPU."""
    if torch.cuda.is_available():
        assert CMMEngine().device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        CMMEngine()
    for name in EXECUTORS:
        with pytest.raises(RuntimeError, match="CUDA"):
            make_executor(name)


def test_unknown_executor_raises():
    with pytest.raises(ValueError, match="unknown executor"):
        make_executor("batched-pallas", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        make_executor("batched", device="cpu", precision="half")


def test_kernel_executors_count_no_launches_on_cpu():
    mm.reset_launches()
    _, port = _engines()
    expr = suite.kmeans(32)
    for ex in ("kernel", "batched-cuda"):
        port.run(expr, tile=16, executor=ex)
    assert [w.launches for w in mm.WRAPPERS] == [0, 0, 0, 0]


def test_auto_picks_the_cheaper_strategy():
    _, port = _engines()
    expr = suite.synth(48)
    plan = port.plan(expr, tile=8)
    port.run(expr, executor="auto", plan=plan)
    assert port.last_exec_stats["executor"] == plan.best_executor
    assert port.last_exec_stats["tasks_run"] == len(plan.program.graph)
    assert port.last_spans, "the flight recorder saw no task"


def test_multi_root_program_shares_subexpressions():
    _, port = _engines()
    a = suite.markov(24)
    b = a * 2.0
    plan = port.plan_many([a, b], tile=8)
    out_a, out_b = port.execute_plan(plan, executor="batched")
    torch.testing.assert_close(out_b, out_a * 2.0)
    torch.testing.assert_close(out_a, a.eager("cpu"), rtol=1e-8, atol=1e-8)


def test_non_square_tile_raises():
    """Transposes always fold into matmul flags, which needs a square tile."""
    _, port = _engines()
    with pytest.raises(ValueError, match="square"):
        port.plan(suite.markov(24), tile=(8, 16))
    assert port.plan(suite.markov(24), tile=(8, 8)).tile == (8, 8)
