"""Parity of the port with the JAX reference on three kinds of expression
the port once got wrong: fused epilogues longer than the ADDMUL kernel
holds, scalar and elementwise ops on integer matrices, and integer
products.

* Long epilogues (``A@B + R1 + ... + R17`` and ``A@B`` under 70 ``sin``)
  through ``kernel`` and ``batched-cuda``, against the reference's
  ``kernel`` and ``batched-pallas`` (Pallas in interpret mode, f32 under
  JAX's x32) at the f32 tier, 1e-4 relative to the largest entry.
* Integer inputs under ``* 2.5``, ``1.0 / (I + 10)`` and ``sqrt`` give f64,
  as NumPy does, on all four executors and ``eager()``, at the f64 tier
  (1e-8).
* An int64 product, alone and under an epilogue, is exact on all four
  executors against the reference's ``local`` (NumPy int64), in NumPy's
  result types.

The port runs on ``device="cpu"`` here, so ``kernel`` and ``batched-cuda``
take their kernels' plain versions; ``chip_smoke.py`` runs the same
expressions on the card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import ClusteredMatrix as RefCM
from repro.core import CMMEngine as RefEngine
from repro.core import analytic_time_model
from repro.core.machine import hetero_spec
from repro_torch import convert
from repro_torch.core import ClusteredMatrix as CM
from repro_torch.core import CMMEngine
from repro_torch.core.graph import TaskKind, matmul_epilogue
from repro_torch.kernels import matmul as mm

TM = analytic_time_model()
SPEC = hetero_spec((3, 2, 1), link_bw=1e12, latency=1e-6)
N, TILE = 32, 16
EXECUTORS = ("local", "batched", "kernel", "batched-cuda")


def _engines():
    ref = RefEngine(SPEC, TM, plan_cache=False)
    port = CMMEngine(convert.spec_from_fields(**dataclasses.asdict(SPEC)),
                     convert.timemodel_from_json(TM.to_json()),
                     plan_cache=False, device="cpu")
    return ref, port


def _inputs():
    rng = np.random.default_rng(17)
    return {"A": rng.standard_normal((N, N)),
            "B": rng.standard_normal((N, N)),
            "R": [rng.standard_normal((N, N)) for _ in range(17)],
            "I": rng.integers(3000, 12000, (N, N)),
            "J": rng.integers(3000, 12000, (N, N)),
            "K": rng.integers(-50, 50, (N, N))}


def _build(name, cls, conv):
    """The probe expression ``name`` in one package (``cls``), its leaves
    made from the shared numpy inputs by ``conv``."""
    x = _inputs()
    leaf = lambda a: cls.from_array(conv(a))   # noqa: E731
    if name == "17 extras":
        e = leaf(x["A"]) @ leaf(x["B"])
        for r in x["R"]:
            e = e + leaf(r)
        return e
    if name == "70 sin":
        e = leaf(x["A"]) @ leaf(x["B"])
        for _ in range(70):
            e = e.ewise("sin")
        return e
    i, j, k = leaf(x["I"]), leaf(x["J"]), leaf(x["K"])
    return {"I*2.5": lambda: i * 2.5,
            "1/(I+10)": lambda: 1.0 / (i + 10),
            "sqrt(I)": lambda: i.ewise("sqrt"),
            "I@J": lambda: i @ j,
            "I@J-K": lambda: i @ j - k,
            "sqrt(I@J+K)*0.5": lambda: (i @ j + k).ewise("sqrt") * 0.5}[name]()


def _pair(name):
    return (_build(name, RefCM, lambda a: a),
            _build(name, CM, torch.from_numpy))


def _close(got: torch.Tensor, want: np.ndarray, tol: float):
    want_t = torch.from_numpy(np.asarray(want, np.float64))
    assert tuple(got.shape) == want_t.shape
    scale = 1.0 if tol <= 1e-8 else max(1.0, float(want_t.abs().max()))
    torch.testing.assert_close(got.double(), want_t, rtol=tol,
                               atol=tol * scale)


# -- long epilogues -------------------------------------------------------------

@pytest.mark.parametrize("ours,theirs", [("kernel", "kernel"),
                                         ("batched-cuda", "batched-pallas")])
@pytest.mark.parametrize("name", ["17 extras", "70 sin"])
def test_long_epilogue_matches_reference_kernels(name, ours, theirs):
    ref, port = _engines()
    ref_expr, expr = _pair(name)
    want = ref.run(ref_expr, tile=TILE, executor=theirs)
    got = port.run(expr, tile=TILE, executor=ours)
    assert got.dtype == torch.float64
    _close(got, want, 1e-4)
    # and the strict oracle, at the f64 tier
    _close(got, ref.run(ref_expr, tile=TILE, executor="local"), 1e-8)


def test_split_epilogue_cuts_where_one_value_crosses():
    """The kernel's head is the longest prefix within the limits whose
    value alone is read on; the tail re-reads the extras it needs."""
    _, port = _engines()
    plan = port.plan(_pair("17 extras")[1], tile=TILE)
    prog = next(matmul_epilogue(t.payload) for t in plan.program.graph
                if t.kind is TaskKind.ADDMUL
                and matmul_epilogue(t.payload) is not None)
    assert prog == (("in", 0),) + sum(
        ((("in", k), ("add", 2 * k - 2, 2 * k - 1)) for k in range(1, 18)),
        ())
    head, used, tail = mm.split_epilogue(prog, 17, False)
    assert len(used) == mm.MAX_EXTRAS and used == tuple(range(16))
    assert head == prog[:33]
    assert tail == (("in", 0), ("in", 17), ("add", 0, 1))
    sins = (("in", 0),) + tuple(("ewise", "sin", i) for i in range(70))
    head, used, tail = mm.split_epilogue(sins, 0, False)
    assert head == sins[:mm.MAX_PROG] and used == ()
    assert tail == (("in", 0),) + tuple(("ewise", "sin", i)
                                        for i in range(71 - mm.MAX_PROG))
    # the accumulator read at the end: no prefix qualifies
    late = sins + (("add", 70, 0),)
    assert mm.split_epilogue(late, 0, False) == ((("in", 0),), (), late)
    # a program that fits runs whole; an integer product runs none of it
    assert mm.split_epilogue(sins[:10], 0, False) == (sins[:10], (), None)
    assert mm.split_epilogue(sins[:10], 0, True) == (None, (), sins[:10])


# -- integer promotion ----------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTORS + ("eager",))
@pytest.mark.parametrize("name", ["I*2.5", "1/(I+10)", "sqrt(I)"])
def test_integer_inputs_promote_to_f64(name, executor):
    ref, port = _engines()
    ref_expr, expr = _pair(name)
    want = ref.run(ref_expr, tile=TILE, executor="local")
    assert want.dtype == np.float64
    got = expr.eager("cpu") if executor == "eager" else \
        port.run(expr, tile=TILE, executor=executor)
    assert got.dtype == torch.float64
    _close(got, want, 1e-8)


# -- integer products -----------------------------------------------------------

@pytest.mark.parametrize("executor", EXECUTORS + ("eager",))
@pytest.mark.parametrize("name", ["I@J", "I@J-K", "sqrt(I@J+K)*0.5"])
def test_integer_product_is_exact(name, executor):
    ref, port = _engines()
    ref_expr, expr = _pair(name)
    want = ref.run(ref_expr, tile=TILE, executor="local")
    got = expr.eager("cpu") if executor == "eager" else \
        port.run(expr, tile=TILE, executor=executor)
    assert str(got.dtype) == "torch." + want.dtype.name
    if want.dtype == np.int64:
        assert np.array_equal(got.numpy(), want)
    else:   # the epilogue's sqrt and scale run in f64, as NumPy's
        _close(got, want, 1e-8)
