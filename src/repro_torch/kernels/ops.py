"""Entry points the executors call for ADDMUL tiles (the JAX reference's
``repro.kernels.ops``).

The reference clamped its Pallas block sizes to each tile
(``_resolve_blocks``).  The CUDA kernel has one block shape
(``matmul.BLOCK``) for every tile and masks the ragged edges itself, so
there is nothing to resolve per shape — and because a tile is computed the
same way alone (``addmul``) and inside a wave group (``addmul_batched``),
the ``kernel`` and ``batched-cuda`` executors agree bitwise.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.fusion import eval_fused
from . import matmul as _mm
from . import ref


def addmul(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
           epilogue: Optional[tuple] = None,
           extras: Sequence[torch.Tensor] = (),
           out_dtype: Optional[torch.dtype] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One tile's ``c + a @ b`` (K1); with ``epilogue`` a FUSED tile
    program, the elementwise chain runs in the same launch (K2)."""
    if epilogue is None:
        return _mm.addmul(c, a, b, out=out)
    return _mm.addmul_epilogue(c, a, b, *extras, prog=tuple(epilogue),
                               out_dtype=out_dtype, out=out)


def addmul_batched(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                   epilogue: Optional[tuple] = None,
                   extras: Sequence[torch.Tensor] = (),
                   out_dtype: Optional[torch.dtype] = None,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A wave group's stacked ``out[g] = epi(c[g] + a[g] @ b[g])`` in one
    launch (K3)."""
    return _mm.addmul_batched(c, a, b, prog=epilogue, extras=extras,
                              out_dtype=out_dtype, out=out)


def addmul_fused(c: torch.Tensor, a: torch.Tensor, b: torch.Tensor, *,
                 epilogue: tuple, extras: Sequence[torch.Tensor] = (),
                 out_dtype: Optional[torch.dtype] = None,
                 batched: bool = False) -> torch.Tensor:
    """``epilogue(c + a @ b, *extras)`` for a program of any length, in one
    tile (K1/K2) or a stacked wave group (K3).

    The kernel runs the head of the program that fits its limits and
    stores it in the epilogue's type; ``fusion.eval_fused`` runs the rest
    over that tile and the extras, then the result is stored in the
    store type (``matmul.split_epilogue`` makes the cut, so a tile is cut
    the same way alone and in a group).  An integer product runs its whole
    program in ``eval_fused``, in NumPy's types, which are the result's."""
    acc = ref.accumulator_dtype(a.dtype, b.dtype, c.dtype)
    head, used, tail = _mm.split_epilogue(tuple(epilogue), len(extras),
                                          acc == torch.int64)
    run = addmul_batched if batched else addmul
    if tail is None:
        return run(c, a, b, epilogue=head, extras=extras, out_dtype=out_dtype)
    if head is None:
        y = run(c, a, b)
    else:
        y = run(c, a, b, epilogue=head, extras=[extras[i] for i in used],
                out_dtype=ref.epilogue_dtype(acc, [extras[i] for i in used]))
    z = eval_fused(tail, [y] + list(extras))
    if out_dtype is None and acc != torch.int64:
        out_dtype = ref.epilogue_out_dtype(c, extras)
    return z if out_dtype is None else z.to(out_dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (K4)."""
    return _mm.matmul(a, b)
