"""Planning parity: the PyTorch port plans exactly what the JAX reference
plans.

The same expression built in both packages (the eight paper workloads at
two tiles, and random DAGs) must give the same random leaves bit for bit,
the same fusion report, the same task list, the same HEFT placements and
starts, and the same simulated makespans — compared with ``==``, under a
TimeModel carried across as ``to_json()`` text and a spec carried across as
its fields.  Expression-node uids are process-global counters that differ
between the packages, so tiles are compared through a canonical renaming.
"""
import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.core import CMMEngine as RefEngine
from repro.core import ClusteredMatrix as RefCM
from repro.core import analytic_time_model, c5_9xlarge
from repro.core.lazy import random_slice as ref_random_slice
from repro.core.machine import hetero_spec
from repro_torch import convert
from repro_torch import suite
from repro_torch.core import CMMEngine, ClusteredMatrix as CM
from repro_torch.core.lazy import random_slice

_spec = importlib.util.spec_from_file_location(
    "ref_cmm_suite", os.path.join(os.path.dirname(__file__), "..",
                                  "benchmarks", "cmm_suite.py"))
ref_suite = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref_suite)

SUITE_N = 48
TILES = (24, 16)


def _timemodels():
    plain = analytic_time_model()
    # a fitted-looking model that also prices the wire codec and the
    # per-task dispatch, so every pricing branch of HEFT/simulate runs
    priced = analytic_time_model(gflops=3.0, mem_gbs=7.0, base_us=12.0)
    priced.dispatch_overhead = 2e-5
    priced.compress_bandwidth = 4e8
    priced.compression_ratio_prior = 2.5
    return {"analytic": plain, "priced": priced}


SPECS = {"one-node": c5_9xlarge(1),
         "hetero-3": hetero_spec((3, 2, 1), link_bw=5e8, latency=1e-4)}
TMS = _timemodels()


def _engines(spec_name, tm_name):
    ref_spec, ref_tm = SPECS[spec_name], TMS[tm_name]
    ref = RefEngine(ref_spec, ref_tm, plan_cache=False)
    port = CMMEngine(convert.spec_from_fields(**dataclasses.asdict(ref_spec)),
                     convert.timemodel_from_json(ref_tm.to_json()),
                     plan_cache=False, device="cpu")
    return ref, port


def canonical_tasks(g):
    """The task list with expression uids renamed in first-use order."""
    ids = {}

    def cid(uid):
        return ids.setdefault(uid, len(ids))

    def tile(r):
        return (cid(r.tensor), r.i, r.j, r.shape)

    out = []
    for tid in sorted(g.tasks):
        t = g.tasks[tid]
        payload = t.payload
        if t.kind.value in ("fill", "calloc"):
            payload = cid(payload)
        out.append((tid, t.kind.value, payload, tuple(map(tile, t.ins)),
                    None if t.out is None else tile(t.out),
                    tuple(sorted(t.preds)), t.flops))
    return out


def assert_same_plan(ref_plan, port_plan):
    port_plan.program.graph.validate()
    assert port_plan.fusion.as_dict() == ref_plan.fusion.as_dict()
    assert canonical_tasks(port_plan.program.graph) == \
        canonical_tasks(ref_plan.program.graph)
    rs, ps = ref_plan.schedule, port_plan.schedule
    assert {t: dataclasses.astuple(p) for t, p in ps.placements.items()} == \
        {t: dataclasses.astuple(p) for t, p in rs.placements.items()}
    assert ps.order == rs.order
    assert ps.makespan == rs.makespan
    assert (ps.cache_hits, ps.cache_misses) == \
        (rs.cache_hits, rs.cache_misses)
    assert port_plan.sim.makespan == ref_plan.sim.makespan
    assert port_plan.batched_makespan == ref_plan.batched_makespan
    assert port_plan.waves == ref_plan.waves
    assert port_plan.best_executor == ref_plan.best_executor


# -- random leaves ------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("seed,shape,box", [
    (0, (300, 200), (0, 300, 0, 200)),
    (7, (300, 200), (100, 257, 128, 199)),
    (3, (129, 1), (5, 129, 0, 1)),
    (11, (64, 512), (0, 64, 130, 400)),
])
def test_random_slice_bitwise(dtype, seed, shape, box):
    want = ref_random_slice(seed, shape, dtype, *box)
    got = random_slice(seed, shape, dtype, *box)
    assert got.dtype == {np.float64: torch.float64,
                         np.float32: torch.float32}[dtype]
    assert np.array_equal(got.numpy(), want)


def test_rand_leaf_materialises_bitwise():
    ref = RefCM.rand(70, 45, seed=5, dtype=np.float32).eager()
    got = CM.rand(70, 45, seed=5, dtype=torch.float32).eager("cpu")
    assert np.array_equal(got.numpy(), ref)


# -- the paper workloads ----------------------------------------------------------

@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("workload", sorted(suite.BENCHMARKS))
def test_suite_plan_parity(workload, tile):
    for spec_name in SPECS:
        for tm_name in TMS:
            ref, port = _engines(spec_name, tm_name)
            assert_same_plan(
                ref.plan(ref_suite.BENCHMARKS[workload](SUITE_N), tile=tile),
                port.plan(suite.BENCHMARKS[workload](SUITE_N), tile=tile))


def test_plan_cache_rebinds_new_leaves():
    port = CMMEngine(device="cpu")
    a = np.arange(36.0).reshape(6, 6)
    y = convert.leaf_from_numpy(a)
    p1 = port.plan(y @ y, tile=4)
    x = convert.leaf_from_numpy(a + 1.0)
    p2 = port.plan(x @ x, tile=4)
    assert p2.cache_hit and not p1.cache_hit
    out = port.run(x @ x, tile=4, plan=p2)
    torch.testing.assert_close(out, torch.from_numpy((a + 1) @ (a + 1)))


# -- random DAGs ----------------------------------------------------------------

SAFE_EWISE = ["sin", "cos", "tanh", "abs", "relu"]
KINDS = ["add", "sub", "ewmul", "matmul", "matmul_t", "scale", "ewise",
         "rscale"]


def rand_expr(rng, CMcls, dtype, depth, m, n, max_inner):
    """A random expression over ``CMcls`` (either package's matrix type),
    drawn from ``rng`` so the same seed builds the same DAG in both."""
    if depth == 0:
        return CMcls.rand(m, n, seed=int(rng.integers(0, 51)), dtype=dtype)
    kind = KINDS[int(rng.integers(len(KINDS)))]
    sub = lambda mm, nn: rand_expr(rng, CMcls, dtype, depth - 1,  # noqa
                                   mm, nn, max_inner)
    if kind in ("matmul", "matmul_t"):
        k = int(rng.integers(1, max_inner + 1))
        if kind == "matmul_t":
            a, b = sub(k, m), sub(k, n)
            return a.T @ b
        a, b = sub(m, k), sub(k, n)
        return a @ b
    if kind in ("add", "sub", "ewmul"):
        a, b = sub(m, n), sub(m, n)
        return {"add": a + b, "sub": a - b, "ewmul": a.hadamard(b)}[kind]
    if kind == "scale":
        return sub(m, n) * float(rng.choice([0.5, 1.5, -2.0, 1.0]))
    if kind == "rscale":
        x = sub(m, n)
        op = int(rng.integers(3))
        return [-x, 3.0 - x, 2.0 + x][op]
    return sub(m, n).ewise(SAFE_EWISE[int(rng.integers(len(SAFE_EWISE)))])


@pytest.mark.parametrize("seed", range(12))
def test_random_dag_plan_parity(seed):
    rng = np.random.default_rng(seed)
    dtype = [np.float64, np.float32][seed % 2]
    tile = int(rng.integers(4, 17))
    m, n = int(rng.integers(2, 30)), int(rng.integers(2, 30))
    depth = int(rng.integers(1, 4))
    exprs = [rand_expr(np.random.default_rng((seed, 1)), CMcls, dtype,
                       depth, m, n, max_inner=2 * tile)
             for CMcls in (RefCM, CM)]
    ref, port = _engines("hetero-3" if seed % 3 else "one-node", "priced")
    assert_same_plan(ref.plan(exprs[0], tile=tile),
                     port.plan(exprs[1], tile=tile))


@pytest.mark.parametrize("seed", range(6))
def test_random_dag_results_match(seed):
    """Every in-process executor of the port against the reference's
    per-task executor on the same random DAG (f64 1e-8, f32 1e-4 scaled
    by the result's largest entry)."""
    rng = np.random.default_rng(100 + seed)
    dtype = [np.float64, np.float32][seed % 2]
    tile = int(rng.integers(4, 17))
    m, n = int(rng.integers(2, 30)), int(rng.integers(2, 30))
    ref_expr, expr = [rand_expr(np.random.default_rng((seed, 2)), CMcls,
                                dtype, 3, m, n, max_inner=2 * tile)
                      for CMcls in (RefCM, CM)]
    ref, port = _engines("one-node", "analytic")
    want = torch.from_numpy(np.asarray(ref.run(ref_expr, tile=tile),
                                       np.float64))
    tol = 1e-8 if dtype == np.float64 else 1e-4
    scale = 1.0 if dtype == np.float64 else max(1.0, float(want.abs().max()))
    for ex in ("local", "batched", "kernel", "batched-cuda"):
        got = port.run(expr, tile=tile, executor=ex)
        assert got.dtype == {np.float64: torch.float64,
                             np.float32: torch.float32}[dtype]
        torch.testing.assert_close(got.double(), want, rtol=tol,
                                   atol=tol * scale)


def _operator_surface(CMcls):
    """Every ClusteredMatrix operator once, over leaves kept away from 0."""
    A = CMcls.rand(12, 12, seed=1, dtype=np.float64).ewise("abs") + 0.5
    B = CMcls.rand(12, 12, seed=2, dtype=np.float64)
    out = [A + B, A - B, 2.0 + A, A * 3.0, 3.0 * A, A @ B, A * B,
           A.hadamard(B), A.T, A / 4.0, 1.0 / A, 2.0 - A, -A, A - 1.5,
           A.sin(), A.cos(), A.relu(), (A @ B.T).relu() + B]
    out += [B.ewise(fn) for fn in ("exp", "tanh", "abs", "sign")]
    out += [A.ewise("sqrt"), (A @ B - 0.5).ewise("sign")]
    return out


def test_operator_surface_matches_reference():
    ref, port = _engines("one-node", "analytic")
    for r, p in zip(_operator_surface(RefCM), _operator_surface(CM)):
        assert p.shape == r.shape and p.op.value == r.op.value
        want = torch.from_numpy(np.asarray(r.eager()))
        torch.testing.assert_close(p.eager("cpu"), want, rtol=1e-12,
                                   atol=1e-12)
        assert_same_plan(ref.plan(r, tile=5), port.plan(p, tile=5))
        torch.testing.assert_close(port.run(p, tile=5, executor="kernel"),
                                   want, rtol=1e-8, atol=1e-8)
