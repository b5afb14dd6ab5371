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

from . import matmul as _mm


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


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (K4)."""
    return _mm.matmul(a, b)
