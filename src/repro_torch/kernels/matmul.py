"""CUDA ADDMUL kernels: build, load, and the four launch wrappers.

``csrc/addmul.cu`` holds one templated kernel, compiled with ``nvcc`` for
``sm_90a`` into ``build/repro_torch/<source hash>/libcmm_kernels.so`` at
first use and loaded with ``ctypes`` (``kernels/cuda.py``).  Each wrapper
below replaces one TPU kernel of the JAX reference:

========================  ==============================================
wrapper                   replaces (``src/repro/kernels/``)
========================  ==============================================
``addmul``                ``matmul.py::addmul`` (``_addmul_kernel``)
``addmul_epilogue``       ``matmul.py::addmul_epilogue`` (``_addmul_epi_kernel``)
``addmul_batched``        ``ops.py::addmul_batched`` (``jax.vmap`` of both)
``matmul``                ``matmul.py::matmul`` (``_mm_kernel``)
========================  ==============================================

What bounds them on the H100: at the CMM tile sizes (256-2048) a tile
product does ~n/12 f64 FLOPs per byte moved (n/6 in f32), far above the
card's ridge point, so the FMA rate bounds them: 67 TFLOP/s FP64 on the
tensor cores, 34 TFLOP/s FP64 and 67 TFLOP/s FP32 on the FMA units the
kernel uses.  Its design answers with a 4x4 register block per thread over
shared-memory stages (4 shared loads feed 16 FMAs per k step); ``wgmma``/TMA
staging is later work.

For tensors on the CPU every wrapper runs its plain PyTorch version
(``kernels/ref.py``); for CUDA tensors it launches the kernel or raises.
Each wrapper counts its launches in ``<wrapper>.launches``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import torch

from . import cuda, ref

#: limits and block shape compiled into the kernel (checked at load).
#: An epilogue program grows with the user's single-consumer elementwise
#: chain (core/fusion.py sets no bound); the paper suite's longest is 7
#: instructions over 3 extras (Leontief).  The wrappers refuse longer
#: programs; the executors cut them with ``split_epilogue``.
MAX_EXTRAS = 16
MAX_PROG = 64
BLOCK = (64, 64, 16)           # (rows, cols, k) of one thread block

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2,
               torch.int32: 3, torch.int64: 4}

#: FUSED-program opcodes, in csrc/addmul.cu's order
_EWISE_OPS = ("sin", "cos", "exp", "tanh", "abs", "relu", "sqrt", "sign")
_SCALE_OPS = {"add": 9, "sub": 10, "rsub": 11, "scale": 12, "mul": 12,
              "ewmul": 12, "div": 13, "rdiv": 14}
_BINARY_OPS = {"add": 15, "sub": 16, "ewmul": 17}


class _Operand(ctypes.Structure):
    _fields_ = [("ptr", ctypes.c_void_p), ("sg", ctypes.c_int64),
                ("sr", ctypes.c_int64), ("sc", ctypes.c_int64),
                ("dtype", ctypes.c_int), ("pad", ctypes.c_int)]


class _Instr(ctypes.Structure):
    _fields_ = [("op", ctypes.c_int), ("a", ctypes.c_int),
                ("b", ctypes.c_int), ("pad", ctypes.c_int),
                ("s", ctypes.c_double)]


class _Params(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in
                 ("G", "M", "N", "K", "has_c", "n_extras", "n_prog",
                  "acc_f64", "epi_f64", "acc_int", "pad1", "pad2")]
                + [(f, _Operand) for f in ("A", "B", "C", "O")]
                + [("E", _Operand * MAX_EXTRAS), ("prog", _Instr * MAX_PROG)])


def encode_program(prog: Sequence[tuple]) -> list:
    """The FUSED tile program as kernel instructions ``(op, a, b, s)``.

    Slot ``("in", 0)`` is the accumulator, ``("in", k)`` extra ``k - 1``.
    Raises ``ValueError`` beyond the kernel's ``MAX_PROG`` instructions.
    """
    if len(prog) > MAX_PROG:
        raise ValueError(f"epilogue program of {len(prog)} instructions "
                         f"exceeds the kernel's limit of {MAX_PROG}")
    out = []
    for ins in prog:
        kind = ins[0]
        if kind == "in":
            out.append((0, ins[1], 0, 0.0))
        elif kind == "ewise":
            out.append((1 + _EWISE_OPS.index(ins[1]), ins[2], 0, 0.0))
        elif kind == "scale":
            out.append((_SCALE_OPS[ins[1]], ins[3], 0, float(ins[2])))
        else:
            out.append((_BINARY_OPS[kind], ins[1], ins[2], 0.0))
    return out


@functools.lru_cache(maxsize=256)
def split_epilogue(prog: tuple, n_extras: int, integer: bool):
    """Cut an epilogue program into what the kernel runs and the rest.

    Returns ``(head, used, tail)``.  ``head`` is the kernel's program over
    the accumulator and the extras ``used`` (0-based, in the order the head
    reads them); ``tail`` is ``None`` when the kernel runs ``prog`` whole,
    else a program for ``fusion.eval_fused`` over ``[head's value] +
    extras`` (the original extras, re-read from memory).  ``head`` is the
    longest prefix of ``prog`` within ``MAX_PROG`` instructions and
    ``MAX_EXTRAS`` extras whose value is the only one the rest reads (the
    extras' ``in`` aside), or ``(("in", 0),)`` when no prefix qualifies.
    An integer product's head is ``None``: the kernel stores the product
    and the whole program runs in ``eval_fused``, in NumPy's types.
    """
    if integer:
        return None, (), prog
    if len(prog) <= MAX_PROG and n_extras <= MAX_EXTRAS:
        return prog, tuple(range(n_extras)), None
    is_extra = [ins[0] == "in" and ins[1] > 0 for ins in prog]
    reads = [_operands(ins) for ins in prog]
    last_read = list(range(len(prog)))
    for i, ops_ in enumerate(reads):
        for j in ops_:
            last_read[j] = i
    acc_at = [i for i, ins in enumerate(prog) if ins == ("in", 0)]
    cut, used = None, []
    for c in range(min(len(prog), MAX_PROG + 1) - 1):
        ins = prog[c]
        if is_extra[c] and ins[1] - 1 not in used:
            used.append(ins[1] - 1)
        if len(used) > MAX_EXTRAS:
            break
        # the kernel stores prog[c] alone: nothing else it computed (the
        # accumulator included) may be read past c
        if all(a <= c for a in acc_at) and all(
                is_extra[i] or last_read[i] <= c for i in range(c)):
            cut, head_used = c, tuple(used)
    if cut is None:
        return (("in", 0),), (), prog
    slot = {k: n + 1 for n, k in enumerate(head_used)}
    head = tuple(("in", slot[ins[1] - 1]) if is_extra[i] else ins
                 for i, ins in enumerate(prog[:cut + 1]))
    # the tail: the head's value, the extras it re-reads, then the rest
    new = {cut: 0}
    tail = [("in", 0)]
    for i in range(cut):
        if is_extra[i] and last_read[i] > cut:
            new[i] = len(tail)
            tail.append(prog[i])
    for i in range(cut + 1, len(prog)):
        new[i] = len(tail)
        tail.append(_renumber(prog[i], new))
    return head, head_used, tuple(tail)


def _operands(ins: tuple) -> tuple:
    """Indices of the earlier instructions an instruction reads."""
    kind = ins[0]
    if kind == "in":
        return ()
    if kind == "ewise":
        return (ins[2],)
    if kind == "scale":
        return (ins[3],)
    return (ins[1], ins[2])


def _renumber(ins: tuple, new: dict) -> tuple:
    kind = ins[0]
    if kind == "in":
        return ins
    if kind == "ewise":
        return (kind, ins[1], new[ins[2]])
    if kind == "scale":
        return (kind, ins[1], ins[2], new[ins[3]])
    return (kind, new[ins[1]], new[ins[2]])


# -- build and load ------------------------------------------------------

def _bind(lib: ctypes.CDLL) -> None:
    lib.cmm_addmul.argtypes = [ctypes.POINTER(_Params), ctypes.c_void_p]
    lib.cmm_addmul.restype = ctypes.c_int
    lib.cmm_error_string.argtypes = [ctypes.c_int]
    lib.cmm_error_string.restype = ctypes.c_char_p
    lib.cmm_params_size.argtypes = []
    lib.cmm_params_size.restype = ctypes.c_int
    lib.cmm_config.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cmm_config.restype = None
    cfg = (ctypes.c_int * 5)()
    lib.cmm_config(cfg)
    if (lib.cmm_params_size() != ctypes.sizeof(_Params)
            or tuple(cfg) != (MAX_EXTRAS, MAX_PROG) + BLOCK):
        raise RuntimeError("libcmm_kernels.so does not match the "
                           "ctypes layout in kernels/matmul.py")


LIBRARY = cuda.CudaLibrary("addmul.cu", "libcmm_kernels", _bind)


# -- launch ----------------------------------------------------------------


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    cuda.reset(WRAPPERS)


def _operand(t: torch.Tensor) -> _Operand:
    code = _DTYPE_CODE.get(t.dtype)
    if code is None:
        raise TypeError(f"the CUDA addmul kernel takes f32, f64, bf16, int32 "
                        f"and int64, not {t.dtype}")
    sg, sr, sc = t.stride()
    return _Operand(t.data_ptr(), sg, sr, sc, code, 0)


def _launch(c: Optional[torch.Tensor], a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, instrs: list,
            extras: Sequence[torch.Tensor]) -> None:
    """Enqueue ``out = epilogue(c + a @ b)`` on 3-D (G, ., .) CUDA tensors;
    ``instrs`` is the encoded epilogue program (empty: none)."""
    G, M, K = a.shape
    N = b.shape[2]
    acc = ref.accumulator_dtype(a.dtype, b.dtype,
                                *(() if c is None else (c.dtype,)))
    p = _Params(G=G, M=M, N=N, K=K, has_c=int(c is not None),
                n_extras=len(extras), n_prog=len(instrs),
                acc_f64=int(acc == torch.float64),
                acc_int=int(acc == torch.int64),
                epi_f64=int(ref.epilogue_dtype(acc, extras)
                            == torch.float64))
    p.A, p.B, p.O = _operand(a), _operand(b), _operand(out)
    if c is not None:
        p.C = _operand(c)
    for i, e in enumerate(extras):
        p.E[i] = _operand(e)
    for i, (op, sa, sb, s) in enumerate(instrs):
        p.prog[i] = _Instr(op, sa, sb, 0, s)
    lib = LIBRARY.load()
    # the launch goes to the calling thread's current device: make it the
    # operands' (executor pool threads start on device 0)
    with torch.cuda.device(a.device):
        rc = lib.cmm_addmul(ctypes.byref(p), cuda.stream_of(a))
    cuda.check_launch(lib.cmm_error_string, rc, "cmm_addmul")


def _check_shapes(c, a, b, extras, batched: bool) -> None:
    nd = 3 if batched else 2
    if a.ndim != nd or b.ndim != nd:
        raise ValueError(f"expected {nd}-D operands, got {tuple(a.shape)} "
                         f"@ {tuple(b.shape)}")
    if a.shape[:-2] != b.shape[:-2] or a.shape[-1] != b.shape[-2]:
        raise ValueError(f"bad matmul shapes {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    want = a.shape[:-1] + b.shape[-1:]
    for t in ([c] if c is not None else []) + list(extras):
        if t.shape != want:
            raise ValueError(f"operand of shape {tuple(t.shape)} where "
                             f"{tuple(want)} is needed")


def _into(out: Optional[torch.Tensor], shape, dtype, device) -> torch.Tensor:
    if out is None:
        return torch.empty(shape, dtype=dtype, device=device)
    if out.shape != shape or out.dtype != dtype:
        raise ValueError(f"out is {tuple(out.shape)} {out.dtype}, the "
                         f"result is {tuple(shape)} {dtype}")
    return out


def _run(wrapper, c, a, b, out, prog, extras, out_dtype, batched):
    """Shared body of the wrappers: the plain version on the CPU, the
    kernel (counted) on CUDA.  ``out`` may alias ``c`` (each element of C
    is read once, by the thread that stores it), never ``a`` or ``b``."""
    _check_shapes(c, a, b, extras, batched)
    if prog is not None and ref.accumulator_dtype(
            a.dtype, b.dtype, c.dtype) == torch.int64:
        raise ValueError("an integer product takes no epilogue program in "
                         "the kernel (NumPy types each instruction); run "
                         "the program with fusion.eval_fused")
    if len(extras) > MAX_EXTRAS:
        raise ValueError(f"{len(extras)} epilogue extras exceed the "
                         f"kernel's limit of {MAX_EXTRAS}")
    # the same limits hold on both paths, so CPU runs refuse what the
    # card would refuse
    instrs = encode_program(prog) if prog is not None else []
    on_cpu = cuda.on_cpu(c, a, b, out, *extras)
    if c is None:
        res_dtype = torch.promote_types(a.dtype, b.dtype)
    elif prog is None:
        res_dtype = c.dtype
    else:
        res_dtype = out_dtype or ref.epilogue_out_dtype(c, extras)
    shape = a.shape[:-1] + b.shape[-1:]
    if on_cpu:
        val = ref.matmul(a, b) if c is None else \
            ref.addmul(c, a, b, prog=prog, extras=extras,
                       out_dtype=res_dtype)
        if out is None:
            return val
        _into(out, shape, res_dtype, out.device).copy_(val)
        return out
    out = _into(out, shape, res_dtype, a.device)
    if not batched:
        c, a, b, out = (None if c is None else c[None]), a[None], b[None], \
            out[None]
        extras = [e[None] for e in extras]
    _launch(c, a, b, out, instrs, extras)
    cuda.count(wrapper)
    return out[0] if not batched else out


def addmul(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1: ``c + a @ b`` in C's dtype; 2-D operands of any strides."""
    return _run(addmul, c, a, b, out, None, (), None, batched=False)


def addmul_epilogue(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                    *extras: torch.Tensor, prog: tuple,
                    out_dtype: Optional[torch.dtype] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2: ``prog(c + a @ b, *extras)`` applied before the single store;
    ``out_dtype`` overrides the store type (bf16 in mixed precision)."""
    return _run(addmul_epilogue, c, a, b, out, tuple(prog), extras,
                out_dtype, batched=False)


def addmul_batched(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                   prog: Optional[tuple] = None,
                   extras: Sequence[torch.Tensor] = (),
                   out_dtype: Optional[torch.dtype] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: ``out[g] = prog(c[g] + a[g] @ b[g], extras[g])`` for every group
    member in one launch; (G, m, k) operands of any strides."""
    return _run(addmul_batched, c, a, b, out,
                None if prog is None else tuple(prog), tuple(extras),
                out_dtype, batched=True)


def matmul(a: torch.Tensor, b: torch.Tensor, *,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K4: ``a @ b`` accumulated from zero, stored as ``promote(a, b)``."""
    return _run(matmul, None, a, b, out, None, (), None, batched=False)


WRAPPERS = (addmul, addmul_epilogue, addmul_batched, matmul)
for _w in WRAPPERS:
    _w.launches = 0
