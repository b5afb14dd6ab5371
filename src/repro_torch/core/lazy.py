"""ClusteredMatrix: the paper's lazy matrix type (CMM §3, Fig. 2), on torch.

User-level matrix expressions build an expression DAG instead of evaluating
eagerly.  ``compute()`` hands the DAG to the engine, which tiles it into a
task-dependency graph, schedules it with cache-aware HEFT, simulates the
schedule, and executes it on a torch device.

Every node has a unique id and carries shape/dtype metadata only — no data
until materialisation.  ``dtype`` is a ``torch.dtype``; numpy dtypes are
accepted at the constructors and mapped.  RANDOM leaves are drawn on the
host with the same counter-based numpy generator as the JAX reference, so
their tiles are bitwise equal to it, then copied to the device.
"""
from __future__ import annotations

import enum
import itertools
import threading
from dataclasses import dataclass, field
from typing import Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device


class Op(enum.Enum):
    """Expression-level operators (pre-tiling)."""

    INPUT = "input"          # materialised data supplied by the user
    RANDOM = "random"        # random matrix generated from dims (paper's P, u)
    ZEROS = "zeros"
    EYE = "eye"
    ADD = "add"
    SUB = "sub"
    MATMUL = "matmul"        # the paper's ``x`` on (m,n)x(n,k)
    EWMUL = "ewmul"          # Hadamard
    SCALE = "scale"          # matrix (+,-,x,/) scalar — Table 1 row 4
    EWISE = "ewise"          # unary sin/cos/... — Table 1 row 3
    TRANSPOSE = "transpose"
    FUSED = "fused"          # optimizer-generated elementwise region
                             # (payload: instruction tuple, see core.fusion)


#: the float type NumPy's float ufuncs (sin, sqrt, ...) compute an integer
#: or boolean input in: the smallest that holds every value exactly
_UFUNC_FLOAT = {torch.bool: torch.float16, torch.int8: torch.float16,
                torch.uint8: torch.float16, torch.int16: torch.float32,
                torch.uint16: torch.float32}


def _ufunc_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast as NumPy casts it for a float ufunc; torch would compute
    an integer input in its default f32 instead."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(_UFUNC_FLOAT.get(x.dtype, torch.float64))


def _scalar_input(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast as NumPy casts it for an op with a Python float: integer
    and boolean arrays become f64 (torch would give f32)."""
    if x.is_floating_point() or x.is_complex():
        return x
    return x.to(torch.float64)


def _float_ufunc(fn):
    return lambda x: fn(_ufunc_input(x))


def _relu(x: torch.Tensor) -> torch.Tensor:
    # np.maximum(x, 0.0): NaN propagates (clamp_min keeps NaN); the Python
    # float makes an integer input f64
    return torch.clamp_min(_scalar_input(x), 0.0)


def _sign(x: torch.Tensor) -> torch.Tensor:
    # np.sign: sign(0) == 0 and sign(NaN) is NaN (torch.sign gives 0 there)
    return torch.where(torch.isnan(x), x, torch.sign(x))


#: unary elementwise functions supported by Op.EWISE (Table 1 row 3), with
#: NumPy's result types: abs and sign keep an integer type, the others
#: compute integers in floating point
EWISE_FNS = {
    "sin": _float_ufunc(torch.sin),
    "cos": _float_ufunc(torch.cos),
    "exp": _float_ufunc(torch.exp),
    "tanh": _float_ufunc(torch.tanh),
    "abs": torch.abs,
    "relu": _relu,
    "sqrt": _float_ufunc(torch.sqrt),
    "sign": _sign,
}

_NP_TO_TORCH = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """``torch.dtype`` for a torch or numpy dtype (or scalar type)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    nd = np.dtype(dtype)
    if nd.name == "bfloat16":                  # ml_dtypes.bfloat16
        return torch.bfloat16
    try:
        return _NP_TO_TORCH[nd]
    except KeyError:
        raise TypeError(f"unsupported matrix dtype {dtype!r}") from None


_id_counter = itertools.count()
_id_lock = threading.Lock()


def _next_id() -> int:
    with _id_lock:
        return next(_id_counter)


@dataclass
class ClusteredMatrix:
    """A lazy 2-D matrix expression node (CMM's ClusteredMatrix)."""

    op: Op
    shape: Tuple[int, int]
    dtype: torch.dtype = torch.float64
    parents: Tuple["ClusteredMatrix", ...] = ()
    #: op-specific payload: tensor for INPUT, seed for RANDOM, fn name for
    #: EWISE, (scalar op kind, float) for SCALE.
    payload: object = None
    name: str = ""
    uid: int = field(default_factory=_next_id)

    # -- constructors -----------------------------------------------------
    @staticmethod
    def from_array(a, name: str = "") -> "ClusteredMatrix":
        """INPUT leaf over a tensor (kept on its device; FILL copies tiles
        to the executor's device) or anything ``torch.as_tensor`` takes."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        if a.ndim == 1:
            a = a.reshape(-1, 1)
        if a.ndim != 2:
            raise ValueError(f"ClusteredMatrix is 2-D, got shape {tuple(a.shape)}")
        return ClusteredMatrix(Op.INPUT, tuple(a.shape), a.dtype, payload=a,
                               name=name)

    @staticmethod
    def rand(m: int, n: int, seed: int = 0, dtype=torch.float64,
             name: str = "") -> "ClusteredMatrix":
        return ClusteredMatrix(Op.RANDOM, (m, n), as_torch_dtype(dtype),
                               payload=int(seed), name=name)

    @staticmethod
    def zeros(m: int, n: int, dtype=torch.float64,
              name: str = "") -> "ClusteredMatrix":
        return ClusteredMatrix(Op.ZEROS, (m, n), as_torch_dtype(dtype),
                               name=name)

    @staticmethod
    def eye(n: int, dtype=torch.float64, name: str = "") -> "ClusteredMatrix":
        return ClusteredMatrix(Op.EYE, (n, n), as_torch_dtype(dtype),
                               name=name)

    # -- metadata ----------------------------------------------------------
    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    def _binop(self, other: "ClusteredMatrix", op: Op) -> "ClusteredMatrix":
        if not isinstance(other, ClusteredMatrix):
            # scalar broadcast (Table 1 row 4)
            return ClusteredMatrix(Op.SCALE, self.shape, self.dtype,
                                   parents=(self,),
                                   payload=(op.value, float(other)))
        if op in (Op.ADD, Op.SUB, Op.EWMUL) and self.shape != other.shape:
            raise ValueError(f"shape mismatch {self.shape} vs {other.shape}")
        dtype = torch.promote_types(self.dtype, other.dtype)
        return ClusteredMatrix(op, self.shape, dtype, parents=(self, other))

    # -- operators ----------------------------------------------------------
    def __add__(self, other):
        return self._binop(other, Op.ADD)

    def __radd__(self, other):
        return self._binop(other, Op.ADD)

    def __sub__(self, other):
        return self._binop(other, Op.SUB)

    def __mul__(self, other):
        """Paper semantics: ``x`` between matrices is matmul; with a scalar,
        elementwise scale (Table 1 rows 1/4/6)."""
        if isinstance(other, ClusteredMatrix):
            return self.__matmul__(other)
        return self._binop(other, Op.SCALE)

    def __rmul__(self, other):
        return self._binop(other, Op.SCALE)

    def __rsub__(self, other):
        """``s - M`` — scalar-minus-matrix (Table 1 row 4, reflected)."""
        return ClusteredMatrix(Op.SCALE, self.shape, self.dtype,
                               parents=(self,), payload=("rsub", float(other)))

    def __truediv__(self, other):
        if isinstance(other, ClusteredMatrix):
            raise TypeError("matrix / matrix is not a CMM operator")
        return ClusteredMatrix(Op.SCALE, self.shape, self.dtype,
                               parents=(self,), payload=("div", float(other)))

    def __rtruediv__(self, other):
        """``s / M`` — elementwise scalar-over-matrix."""
        return ClusteredMatrix(Op.SCALE, self.shape, self.dtype,
                               parents=(self,), payload=("rdiv", float(other)))

    def __neg__(self):
        """``-M`` == ``M * -1.0`` (IEEE negation is a sign-bit flip, and so
        is multiplication by -1.0)."""
        return ClusteredMatrix(Op.SCALE, self.shape, self.dtype,
                               parents=(self,), payload=("scale", -1.0))

    def __matmul__(self, other: "ClusteredMatrix") -> "ClusteredMatrix":
        if not isinstance(other, ClusteredMatrix):
            raise TypeError("@ needs a ClusteredMatrix")
        if self.n != other.m:
            raise ValueError(
                f"matmul inner-dim mismatch: {self.shape} @ {other.shape}")
        dtype = torch.promote_types(self.dtype, other.dtype)
        return ClusteredMatrix(Op.MATMUL, (self.m, other.n), dtype,
                               parents=(self, other))

    def hadamard(self, other: "ClusteredMatrix") -> "ClusteredMatrix":
        return self._binop(other, Op.EWMUL)

    @property
    def T(self) -> "ClusteredMatrix":
        return ClusteredMatrix(Op.TRANSPOSE, (self.n, self.m), self.dtype,
                               parents=(self,))

    def ewise(self, fn: str) -> "ClusteredMatrix":
        if fn not in EWISE_FNS:
            raise ValueError(f"unknown elementwise fn {fn!r}")
        return ClusteredMatrix(Op.EWISE, self.shape, self.dtype,
                               parents=(self,), payload=fn)

    def sin(self):
        return self.ewise("sin")

    def cos(self):
        return self.ewise("cos")

    def relu(self):
        return self.ewise("relu")

    # -- evaluation ----------------------------------------------------------
    def compute(self, engine=None, **kw) -> torch.Tensor:
        """Materialise through the CMM engine (tiling + HEFT + execution);
        a fresh engine on the default (CUDA) device when none is given."""
        if engine is None:
            from .engine import CMMEngine  # local import to avoid cycle
            engine = CMMEngine()
        return engine.run(self, **kw)

    def eager(self, device=None) -> torch.Tensor:
        """Reference evaluation — direct recursive torch (the oracle)."""
        return eager_eval(self, device)

    # dataclass-generated __eq__ would recurse; identity semantics instead
    def __hash__(self):
        return self.uid

    def __eq__(self, other):
        return self is other

    def __repr__(self):
        ps = ",".join(str(p.uid) for p in self.parents)
        return (f"ClusteredMatrix(#{self.uid} {self.op.value} {self.shape} "
                f"{self.dtype} parents=[{ps}] {self.name})")


def topo_order(root: ClusteredMatrix) -> Sequence[ClusteredMatrix]:
    """Deterministic post-order DFS over the expression DAG."""
    return topo_order_many((root,))


def topo_order_many(roots: Sequence[ClusteredMatrix]
                    ) -> Sequence[ClusteredMatrix]:
    """Post-order DFS over the union of several roots' DAGs (shared
    subexpressions appear once)."""
    seen, order = set(), []

    def visit(node: ClusteredMatrix):
        if node.uid in seen:
            return
        seen.add(node.uid)
        for p in node.parents:
            visit(p)
        order.append(node)

    for root in roots:
        visit(root)
    return order


#: canonical RNG block edge for RANDOM leaves.  Random data is DEFINED as a
#: grid of RNG_BLOCK x RNG_BLOCK blocks, block (bi, bj) drawn from
#: ``default_rng((seed, bi, bj))`` — so any slice of the matrix can be
#: generated standalone and is bit-identical to the full materialisation
#: (and to the JAX reference's), whatever the execution tile size.
RNG_BLOCK = 128


def _host_random(seed: int, shape: Tuple[int, int], np_dtype,
                 r0: int, r1: int, c0: int, c1: int) -> np.ndarray:
    out = np.empty((r1 - r0, c1 - c0), dtype=np_dtype)
    m, n = shape
    B = RNG_BLOCK
    for bi in range(r0 // B, -(-r1 // B)):
        br0, br1 = bi * B, min((bi + 1) * B, m)
        for bj in range(c0 // B, -(-c1 // B)):
            bc0, bc1 = bj * B, min((bj + 1) * B, n)
            rng = np.random.default_rng((seed, bi, bj))
            blk = rng.standard_normal((br1 - br0, bc1 - bc0))
            ir0, ir1 = max(r0, br0), min(r1, br1)
            ic0, ic1 = max(c0, bc0), min(c1, bc1)
            out[ir0 - r0:ir1 - r0, ic0 - c0:ic1 - c0] = \
                blk[ir0 - br0:ir1 - br0, ic0 - bc0:ic1 - bc0]
    return out


def random_slice(seed: int, shape: Tuple[int, int], dtype,
                 r0: int, r1: int, c0: int, c1: int,
                 device="cpu") -> torch.Tensor:
    """Rows ``r0:r1`` x cols ``c0:c1`` of the canonical random matrix
    ``(seed, shape)``, drawn on the host and copied to ``device``."""
    dtype = as_torch_dtype(dtype)
    # numpy rounds the f64 draws into f32/f64 exactly as the reference
    # does; bf16 (no numpy type) rounds from f64 through torch
    np_dtype = {torch.float32: np.float32}.get(dtype, np.float64)
    host = torch.from_numpy(_host_random(seed, shape, np_dtype,
                                         r0, r1, c0, c1))
    return host.to(device=device, dtype=dtype)


def leaf_slice(node: ClusteredMatrix, r0: int, r1: int, c0: int, c1: int,
               device="cpu") -> torch.Tensor:
    """One tile of a leaf on ``device``, built without touching other tiles.

    INPUT returns a view into the user tensor when it already lies on
    ``device`` (zero-copy) and a copy of just the tile otherwise; RANDOM
    draws only the covering canonical blocks; ZEROS/EYE build just the tile.
    """
    if node.op is Op.INPUT:
        return node.payload[r0:r1, c0:c1].to(device=device, dtype=node.dtype)
    if node.op is Op.RANDOM:
        return random_slice(node.payload, node.shape, node.dtype,
                            r0, r1, c0, c1, device)
    if node.op is Op.ZEROS:
        return torch.zeros((r1 - r0, c1 - c0), dtype=node.dtype,
                           device=device)
    if node.op is Op.EYE:
        t = torch.zeros((r1 - r0, c1 - c0), dtype=node.dtype, device=device)
        for k in range(max(r0, c0), min(r1, c1)):
            t[k - r0, k - c0] = 1
        return t
    raise ValueError(f"{node.op} is not a leaf")


def materialize_leaf(node: ClusteredMatrix, device="cpu") -> torch.Tensor:
    """The full tensor for a leaf node (INPUT/RANDOM/ZEROS/EYE)."""
    if node.op is Op.INPUT:
        return node.payload.to(device=device, dtype=node.dtype)
    if node.op is Op.RANDOM:
        return random_slice(node.payload, node.shape, node.dtype,
                            0, node.shape[0], 0, node.shape[1], device)
    if node.op is Op.ZEROS:
        return torch.zeros(node.shape, dtype=node.dtype, device=device)
    if node.op is Op.EYE:
        return torch.eye(node.shape[0], dtype=node.dtype, device=device)
    raise ValueError(f"{node.op} is not a leaf")


def apply_scale(kind: str, x: torch.Tensor, s: float) -> torch.Tensor:
    """``x (op) s`` for a Python float ``s``, in NumPy's result type (an
    integer ``x`` gives f64)."""
    x = _scalar_input(x)
    if kind == "add":
        return x + s
    if kind == "sub":
        return x - s
    if kind == "rsub":
        return s - x
    if kind in ("scale", "mul", "ewmul"):
        return x * s
    if kind == "div":
        return x / s
    if kind == "rdiv":
        return s / x
    raise ValueError(f"unknown scalar op {kind}")


def card_integer_product(a: torch.Tensor, b: torch.Tensor) -> bool:
    """True for an integer product on a CUDA device.  torch has no CUDA
    integer matmul, so such a product runs in the port's own ADDMUL kernel
    (exact int64 accumulation, as NumPy's)."""
    return (a.device.type == "cuda"
            and not torch.promote_types(a.dtype, b.dtype).is_floating_point)


def promoted_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with NumPy's dtype promotion (torch.matmul needs equal
    dtypes); a 2-D integer product on the card runs in the port's K4."""
    if card_integer_product(a, b):
        from ..kernels import matmul as mm   # local import: kernels use core
        return mm.matmul(a, b)
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.matmul(a.to(dt), b.to(dt))


def eager_eval(root: ClusteredMatrix, device=None) -> torch.Tensor:
    """Direct torch oracle used to validate the tiled/scheduled execution.
    ``device=None`` is the CUDA device (``device.resolve_device``)."""
    device = resolve_device(device)
    vals = {}
    for node in topo_order(root):
        if node.op in (Op.INPUT, Op.RANDOM, Op.ZEROS, Op.EYE):
            vals[node.uid] = materialize_leaf(node, device)
        elif node.op is Op.ADD:
            vals[node.uid] = vals[node.parents[0].uid] + vals[node.parents[1].uid]
        elif node.op is Op.SUB:
            vals[node.uid] = vals[node.parents[0].uid] - vals[node.parents[1].uid]
        elif node.op is Op.EWMUL:
            vals[node.uid] = vals[node.parents[0].uid] * vals[node.parents[1].uid]
        elif node.op is Op.MATMUL:
            from .graph import matmul_epilogue, matmul_flags
            a = vals[node.parents[0].uid]
            b = vals[node.parents[1].uid]
            ta, tb = matmul_flags(node.payload)  # folded-transpose flags
            c = promoted_matmul(a.T if ta else a, b.T if tb else b)
            epi = matmul_epilogue(node.payload)
            if epi is not None:
                from .fusion import eval_fused   # local import (cycle)
                c = eval_fused(epi, [c] + [vals[p.uid]
                                           for p in node.parents[2:]])
            vals[node.uid] = c
        elif node.op is Op.FUSED:
            from .fusion import eval_fused   # local import (cycle)
            vals[node.uid] = eval_fused(
                node.payload, [vals[p.uid] for p in node.parents])
        elif node.op is Op.SCALE:
            kind, s = node.payload
            vals[node.uid] = apply_scale(kind, vals[node.parents[0].uid], s)
        elif node.op is Op.EWISE:
            vals[node.uid] = EWISE_FNS[node.payload](vals[node.parents[0].uid])
        elif node.op is Op.TRANSPOSE:
            vals[node.uid] = vals[node.parents[0].uid].T
        else:  # pragma: no cover
            raise ValueError(node.op)
    return vals[root.uid]
