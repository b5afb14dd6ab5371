"""Plain PyTorch versions of the CUDA kernels in ``csrc/addmul.cu``.

Each function computes what its kernel computes, with the same accumulator
and epilogue types, through ``torch.matmul`` and ``fusion.eval_fused``.
The kernel wrappers (``kernels/matmul.py``) run these for tensors that lie
on the CPU; ``chip_smoke.py`` holds each kernel against its plain version
on the card.  The summation order differs from the kernel's, so the two
agree to a tolerance, not bitwise.
"""
from __future__ import annotations

from functools import reduce
from typing import Optional, Sequence

import torch

from ..core.fusion import eval_fused


def accumulator_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """f64 if any operand is f64, else f32 (f32 and bf16 accumulate in f32,
    as the TPU kernel does)."""
    return torch.float64 if torch.float64 in dtypes else torch.float32


def epilogue_dtype(acc: torch.dtype,
                   extras: Sequence[torch.Tensor]) -> torch.dtype:
    """The type the epilogue program runs in: f64 when the accumulator or
    any extra operand is f64, else f32."""
    return accumulator_dtype(acc, *[e.dtype for e in extras])


def epilogue_out_dtype(c: torch.Tensor,
                       extras: Sequence[torch.Tensor]) -> torch.dtype:
    """Default store type of an epilogued addmul: the promotion over C and
    the extras (the reference's ``out_dtype=None``)."""
    return reduce(torch.promote_types, [e.dtype for e in extras], c.dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` accumulated in the accumulator type, stored as
    ``promote(a, b)``."""
    acc = accumulator_dtype(a.dtype, b.dtype)
    return torch.matmul(a.to(acc), b.to(acc)).to(
        torch.promote_types(a.dtype, b.dtype))


def addmul(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
           prog: Optional[tuple] = None,
           extras: Sequence[torch.Tensor] = (),
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``epilogue(c + a @ b, extras...)`` over any leading batch shape.

    Without ``prog`` the result is stored in C's dtype; with it, in
    ``out_dtype`` or the promotion over C and the extras."""
    acc = accumulator_dtype(a.dtype, b.dtype, c.dtype)
    x = c.to(acc) + torch.matmul(a.to(acc), b.to(acc))
    if prog is None:
        return x.to(c.dtype)
    epi = epilogue_dtype(acc, extras)
    y = eval_fused(prog, [x.to(epi)] + [e.to(epi) for e in extras])
    return y.to(out_dtype or epilogue_out_dtype(c, extras))
