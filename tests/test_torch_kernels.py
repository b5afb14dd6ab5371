"""Kernel parity: the plain versions behind the CUDA kernel wrappers
(the path a wrapper takes for CPU tensors) against the JAX reference's
Pallas kernels, run in interpret mode on the CPU as ``tests/test_kernels.py``
runs them, on the same numpy inputs.

Tolerances: f32 1e-4 relative / 1e-5 absolute, bf16 5e-2 (the kernel tier of
TESTING.md).  The kernels themselves only run on a CUDA card, where
``chip_smoke.py`` holds each one against these same plain versions.  This
file also holds the wrappers' guards: program encoding and limits, dtype
and device checks, and the launch counters staying 0 off the card.
"""
import ast
import pathlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.kernels import matmul as mm
from repro_torch.kernels import ops, ref

#: every FUSED-program instruction at least once; slot 0 is the
#: accumulator, slots 1 and 2 two extras of different dtypes
PROG_EWISE = (("in", 0), ("scale", "mul", 1e-2, 0), ("ewise", "sin", 1),
              ("ewise", "cos", 1), ("ewise", "exp", 1),
              ("ewise", "tanh", 1), ("ewise", "abs", 1),
              ("ewise", "sqrt", 6), ("ewise", "sign", 1),
              ("add", 2, 3), ("add", 9, 4), ("ewmul", 10, 5),
              ("sub", 11, 7), ("add", 12, 8), ("ewise", "relu", 13))
PROG_SCALE = (("in", 0), ("in", 1), ("in", 2), ("add", 0, 1),
              ("sub", 3, 2), ("scale", "add", 1.5, 4),
              ("scale", "sub", 0.5, 5), ("scale", "rsub", 2.0, 6),
              ("scale", "scale", 0.25, 7), ("scale", "mul", -1.5, 8),
              ("scale", "ewmul", 0.5, 9), ("ewise", "abs", 10),
              ("scale", "add", 1.0, 11), ("scale", "rdiv", 3.0, 12),
              ("scale", "div", 7.0, 13), ("ewmul", 14, 2))
PROG_RELU = (("in", 0), ("scale", "sub", 0.5, 0), ("ewise", "relu", 1))

SHAPES = [(64, 64, 64), (100, 70, 130), (4, 16, 4)]
_JNP = {"f32": jnp.float32, "bf16": jnp.bfloat16}
_TORCH = {"f32": torch.float32, "bf16": torch.bfloat16}


def _tol(dt):
    return dict(rtol=5e-2, atol=5e-2) if dt == "bf16" \
        else dict(rtol=1e-4, atol=1e-5)


def _pair(rng, shape, dt):
    """One input in both frameworks: an f32 draw rounded once to ``dt``."""
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x, _JNP[dt]), torch.from_numpy(x).to(_TORCH[dt])


def _close(got: torch.Tensor, want, dt):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(), want, **_tol(dt))


# -- K1 / K4 ------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", SHAPES)
def test_addmul_matches_pallas(m, k, n, dt):
    rng = np.random.default_rng(m + 3 * n)
    (ja, ta), (jb, tb), (jc, tc) = (_pair(rng, s, dt) for s in
                                    ((m, k), (k, n), (m, n)))
    got = ops.addmul(tc, ta, tb)
    assert got.dtype == tc.dtype
    _close(got, ref_ops.addmul(jc, ja, jb), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", SHAPES[:2])
def test_matmul_matches_pallas(m, k, n, dt):
    rng = np.random.default_rng(m * 7 + n)
    (ja, ta), (jb, tb) = (_pair(rng, s, dt) for s in ((m, k), (k, n)))
    got = ops.matmul(ta, tb)
    assert got.dtype == _TORCH[dt]
    _close(got, ref_ops.matmul(ja, jb), dt)


def test_transposed_operands_take_strided_views():
    """The executors hand A^T / B^T as views; the result is the same as
    for contiguous copies (the reference copies with ascontiguousarray)."""
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((20, 12)))
    b = torch.from_numpy(rng.standard_normal((9, 20)))
    c = torch.from_numpy(rng.standard_normal((12, 9)))
    got = ops.addmul(c, a.T, b.T)
    torch.testing.assert_close(got, ops.addmul(c, a.T.contiguous(),
                                               b.T.contiguous()))
    torch.testing.assert_close(got, c + a.T @ b.T)


# -- K2 -----------------------------------------------------------------------

@pytest.mark.parametrize("name,prog,dt", [
    ("ewise", PROG_EWISE, "f32"),
    ("scale", PROG_SCALE, "f32"),
    ("relu", PROG_RELU, "f32"),
    ("scale", PROG_SCALE, "bf16"),
])
def test_addmul_epilogue_matches_pallas(name, prog, dt):
    m, k, n = 100, 70, 130
    rng = np.random.default_rng(len(prog))
    (ja, ta), (jb, tb), (jc, tc) = (_pair(rng, s, dt) for s in
                                    ((m, k), (k, n), (m, n)))
    # extras of mixed types: f32 and bf16 (or f32 twice for bf16 tiles)
    (je1, te1) = _pair(rng, (m, n), "f32")
    (je2, te2) = _pair(rng, (m, n), "bf16" if dt == "f32" else "f32")
    extras_j, extras_t = ([je1, je2], [te1, te2]) if name != "ewise" \
        else ([], [])
    want = ref_ops.addmul(jc, ja, jb, epilogue=prog, extras=extras_j)
    got = ops.addmul(tc, ta, tb, epilogue=prog, extras=extras_t)
    assert str(got.dtype) == "torch." + str(want.dtype)
    _close(got, want, "f32" if got.dtype == torch.float32 else "bf16")


def test_epilogue_bf16_store_matches_pallas():
    """Mixed precision: f32 accumulate, bf16 store (``out_dtype``)."""
    rng = np.random.default_rng(5)
    (ja, ta), (jb, tb), (jc, tc) = (_pair(rng, s, "f32") for s in
                                    ((33, 40), (40, 17), (33, 17)))
    want = ref_ops.addmul(jc, ja, jb, epilogue=PROG_RELU,
                          out_dtype=ml_dtypes.bfloat16)
    got = ops.addmul(tc, ta, tb, epilogue=PROG_RELU,
                     out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got, want, "bf16")


# -- K3 -----------------------------------------------------------------------

@pytest.mark.parametrize("with_epilogue", [False, True])
def test_addmul_batched_matches_pallas(with_epilogue):
    G, m, k, n = 3, 24, 40, 20
    rng = np.random.default_rng(G + with_epilogue)
    (ja, ta), (jb, tb), (jc, tc), (je, te) = (
        _pair(rng, s, "f32") for s in ((G, m, k), (G, k, n), (G, m, n),
                                       (G, m, n)))
    prog = PROG_SCALE[:3] + (("add", 0, 1), ("ewise", "relu", 3)) \
        if with_epilogue else None
    kw_j = dict(epilogue=prog, extras=[je, je]) if prog else {}
    kw_t = dict(epilogue=prog, extras=[te, te]) if prog else {}
    want = ref_ops.addmul_batched(jc, ja, jb, **kw_j)
    got = ops.addmul_batched(tc, ta, tb, **kw_t)
    _close(got, want, "f32")
    # a group member is the single-tile function of its slices
    for g in range(G):
        one = ops.addmul(tc[g], ta[g], tb[g], epilogue=prog,
                         extras=[te[g], te[g]] if prog else ())
        torch.testing.assert_close(got[g], one)


# -- wrapper guards -------------------------------------------------------------

def test_program_encoding_covers_every_instruction():
    enc = mm.encode_program(PROG_EWISE + PROG_SCALE[1:])
    ops_used = {op for op, *_ in enc}
    assert ops_used == set(range(18))           # csrc/addmul.cu OP_COUNT
    assert enc[1] == (12, 0, 0, 1e-2)           # scale mul: slot, scalar
    assert mm.encode_program((("in", 2), ("sub", 0, 0)))[1] == (16, 0, 0, 0.0)


def test_overlong_epilogue_program_raises():
    prog = (("in", 0),) + tuple(("scale", "add", 1.0, i)
                                for i in range(mm.MAX_PROG))
    c = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="exceeds the kernel's limit"):
        ops.addmul(c, c, c, epilogue=prog)
    ok = prog[:mm.MAX_PROG]
    assert ops.addmul(c, c, c, epilogue=ok).shape == (4, 4)


def test_too_many_extras_raise():
    c = torch.zeros(2, 2)
    with pytest.raises(ValueError, match="extras"):
        ops.addmul(c, c, c, epilogue=(("in", 0),),
                   extras=[c] * (mm.MAX_EXTRAS + 1))


def test_wrappers_reject_bad_shapes_and_mixed_devices():
    c = torch.zeros(3, 4)
    with pytest.raises(ValueError):
        ops.addmul(c, torch.zeros(3, 5), torch.zeros(4, 4))
    with pytest.raises(ValueError):
        ops.addmul_batched(c, c, c)                       # 2-D into K3
    meta = torch.zeros(4, 4, device="meta")
    with pytest.raises(ValueError, match="devices"):
        ops.addmul(c, torch.zeros(3, 4), meta)


def test_kernel_type_check_names_supported_dtypes():
    with pytest.raises(TypeError, match="f32, f64, bf16, int32 and int64"):
        mm._operand(torch.zeros(2, 2, 2, dtype=torch.float16))


def test_plain_versions_follow_the_accumulator_rules():
    a64 = torch.ones(2, 3, dtype=torch.float64)
    b32 = torch.ones(3, 2)
    c16 = torch.ones(2, 2, dtype=torch.bfloat16)
    assert ref.accumulator_dtype(torch.bfloat16, torch.float32) == \
        torch.float32
    assert ref.addmul(c16, b32.T, b32).dtype == torch.bfloat16
    assert ref.matmul(a64, b32).dtype == torch.float64
    out = ref.addmul(c16, b32.T, b32, prog=PROG_RELU,
                     extras=[torch.ones(2, 2, dtype=torch.float64)])
    assert out.dtype == torch.float64


def test_launch_counters_stay_zero_on_cpu():
    mm.reset_launches()
    c = torch.ones(8, 8)
    ops.addmul(c, c, c)
    ops.addmul(c, c, c, epilogue=PROG_RELU)
    ops.addmul_batched(c[None], c[None], c[None])
    ops.matmul(c, c)
    assert [w.launches for w in mm.WRAPPERS] == [0, 0, 0, 0]


# -- the port stands alone --------------------------------------------------------

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in (ROOT / "src" / "repro_torch").rglob(
        "*.py")] + [pathlib.Path("chip_smoke.py")]), ids=str)
def test_port_imports_neither_jax_nor_the_reference(path):
    for mod in _imports(ROOT / path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {mod}"


def test_import_guard_covers_the_lm_slice():
    """The guard above walks every module of the port, the LM serving
    slice's subpackages included."""
    guarded = {p.relative_to(ROOT / "src" / "repro_torch").parts[0]
               for p in (ROOT / "src" / "repro_torch").rglob("*.py")}
    assert {"configs", "models", "launch", "kernels"} <= guarded
    for name in ("attention.py", "gla.py", "cuda.py"):
        assert (ROOT / "src" / "repro_torch" / "kernels" / name).exists()
