"""Plain PyTorch versions of the CUDA kernels in ``csrc/``.

Each function computes what its kernel computes, with the same accumulator
and epilogue types, through ``torch.matmul`` and ``fusion.eval_fused``:
``matmul``/``addmul`` for ``addmul.cu``, ``flash_attention`` for
``flash_attention.cu``, ``gla`` for ``gla.cu``.  The kernel wrappers
(``kernels/matmul.py``, ``attention.py``, ``gla.py``) run these for tensors
that lie on the CPU; ``chip_smoke.py`` holds each kernel against its plain
version on the card.  The summation order differs from the kernel's, so the
two agree to a tolerance, not bitwise.
"""
from __future__ import annotations

import math
from functools import reduce
from typing import Optional, Sequence, Tuple

import torch

from ..core.fusion import eval_fused


def accumulator_dtype(*dtypes: torch.dtype) -> torch.dtype:
    """f64 if any operand is f64; int64 if no operand is a float (exact,
    wrapping around as NumPy's int64 does); else f32 (f32 and bf16
    accumulate in f32, as the TPU kernel does)."""
    if torch.float64 in dtypes:
        return torch.float64
    if not any(d.is_floating_point for d in dtypes):
        return torch.int64
    return torch.float32


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


NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v on (B, H, S, D) q and (B, KV, Sk, D) k/v,
    query head h reading kv head ``h // (H // KV)``; stored as q.dtype.

    The Pallas kernel's math: f32 scores, masked entries set to -1e30
    (causal keeps ``col <= row``, rows and columns counted from 0), the
    probabilities rounded to v.dtype before the product with v, an f32 sum
    of the unrounded probabilities as the normaliser, floored at 1e-30."""
    b, h, s, d = q.shape
    kvh, sk = k.shape[1], k.shape[2]
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    k = k.repeat_interleave(h // kvh, dim=1)
    v = v.repeat_interleave(h // kvh, dim=1)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
        * (1.0 / math.sqrt(d))
    if causal:
        rows = torch.arange(s, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        scores = scores.masked_fill(cols > rows, NEG_INF)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    out = out / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return out.to(q.dtype)


def gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        log_a: torch.Tensor, chunk: int = 128, normalize: bool = True
        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Chunkwise gated linear attention from a zero state.

    q, k (B, S, H, dk); v (B, S, H, dv); log_a (B, S, H) per-step log
    decay.  Returns y (B, S, H, dv) in v.dtype and the final f32 state
    (B, H, dk, dv) and normaliser (B, H, dk).  All state math in f32,
    chunk by chunk as the reference's ``models/ssm.py::chunkwise_gla``:
    ``F`` is the in-chunk cumulative log decay, the intra-chunk decay
    ``exp(F_i - F_j)`` has its exponent masked to -1e30 above the diagonal
    before ``exp``, and with ``normalize`` y is divided by
    ``max(|q . n|, 1)``."""
    b, s, h, dk = q.shape
    dv = v.shape[-1]
    if s % chunk:
        raise ValueError(f"seq {s} % chunk {chunk} != 0")
    f32 = torch.float32
    state = torch.zeros(b, h, dk, dv, dtype=f32, device=q.device)
    norm = torch.zeros(b, h, dk, dtype=f32, device=q.device)
    mask = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=q.device).tril()
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        qb, kb, vb = q[:, sl].to(f32), k[:, sl].to(f32), v[:, sl].to(f32)
        F = torch.cumsum(log_a[:, sl].to(f32), dim=1)        # (B, c, H)
        total = F[:, -1]                                      # (B, H)
        q_dec = qb * torch.exp(F)[..., None]
        y_inter = torch.einsum("bchk,bhkv->bchv", q_dec, state)
        n_inter = torch.einsum("bchk,bhk->bch", q_dec, norm)
        qk = torch.einsum("bchk,bdhk->bhcd", qb, kb)
        dF = (F[:, :, None, :] - F[:, None, :, :]).permute(0, 3, 1, 2)
        scores = qk * torch.exp(dF.masked_fill(~mask, NEG_INF))
        y_intra = torch.einsum("bhcd,bdhv->bchv", scores, vb)
        n_intra = scores.sum(-1).transpose(1, 2)              # (B, c, H)
        k_tail = kb * torch.exp(total[:, None] - F)[..., None]
        state = (torch.exp(total)[..., None, None] * state
                 + torch.einsum("bchk,bchv->bhkv", k_tail, vb))
        norm = torch.exp(total)[..., None] * norm + k_tail.sum(1)
        y = y_inter + y_intra
        if normalize:
            y = y / (n_inter + n_intra).abs().clamp_min(1.0)[..., None]
        ys.append(y.to(v.dtype))
    return torch.cat(ys, dim=1), (state, norm)
