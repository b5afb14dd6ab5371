"""Shared layers of the LM stack, as functions on tensors.

The counterpart of ``src/repro/models/layers.py`` for the serving path.
``attention`` is where prefill meets the flash-attention kernel (K5): on
CUDA tensors it launches ``kernels/attention.py``, on CPU tensors that
wrapper runs its plain version; ``kernels=False`` runs the plain version
on any device (the reference run on the card).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from ..kernels import attention as fa
from ..kernels import ref


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with f32 internals, cast back to x.dtype."""
    x32 = x.float()
    r = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    return (x32 * r * scale.float()).to(x.dtype)


def act_fn(name: str):
    """The MLP activation; the ported families use SiLU only."""
    if name == "silu":
        return F.silu
    raise ValueError(f"activation {name!r} is not ported")


def rope_tables(positions: torch.Tensor, dim: int, theta: float = 1e6
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin tables (..., dim/2), f32."""
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, dim, 2, dtype=torch.float32, device=positions.device) / dim)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (S, D/2) or broadcastable."""
    x1, x2 = x.float().chunk(2, dim=-1)
    if cos.ndim == 2:                    # (S, D/2): broadcast over heads
        cos, sin = cos[:, None, :], sin[:, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, kernels: bool = True) -> torch.Tensor:
    """Grouped-query attention in the (B, S, H, D) layout; k/v carry the KV
    heads, never repeated.  Causal rows and columns count from 0 (the
    reference's ``q_offset=0``)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if kernels:
        o = fa.flash_attention(qt, kt, vt, causal=causal)
    else:
        o = ref.flash_attention(qt, kt, vt, causal=causal)
    return o.transpose(1, 2)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """Single-token attention: q (B, 1, H, D) against the first ``length``
    positions of a (B, S, H, D) cache (the reference masks the rest to
    -1e30, which contributes exactly 0)."""
    d = q.shape[-1]
    kc, vc = k_cache[:, :length], v_cache[:, :length]
    logits = torch.einsum("bqhd,bshd->bhqs", q.float(), kc.float()) \
        / math.sqrt(d)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqs,bshd->bqhd", p.to(vc.dtype), vc)
