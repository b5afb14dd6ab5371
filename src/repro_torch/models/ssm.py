"""Gated linear attention for the mLSTM (xLSTM) blocks.

The counterpart of ``src/repro/models/ssm.py`` for the serving path:

    state S_t (dk x dv):  S_t = a_t S_{t-1} + k_t^T v_t
    normaliser n_t (dk):  n_t = a_t n_{t-1} + k_t
    output:               y_t = q_t S_t / max(|q_t . n_t|, 1)

``chunkwise_gla`` (prefill) runs the chunkwise-parallel form through the
GLA kernel (K6, ``kernels/gla.py``) on CUDA tensors and its plain version
on CPU tensors, or on any device with ``kernels=False``;
``gla_decode_step`` is the one-token recurrence, plain PyTorch (the
reference has no kernel for it).
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import gla as gla_kernel
from ..kernels import ref


def chunkwise_gla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_a: torch.Tensor, chunk: int = 128,
                  normalize: bool = True, kernels: bool = True
                  ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q, k (B, S, H, dk); v (B, S, H, dv); log_a (B, S, H) per-step log
    decay (<= 0).  Returns y (B, S, H, dv) and the final f32 state
    (B, H, dk, dv) and normaliser (B, H, dk), from a zero state."""
    fn = gla_kernel.gla if kernels else ref.gla
    return fn(q, k, v, log_a, chunk=chunk, normalize=normalize)


def gla_decode_step(state: torch.Tensor, norm: torch.Tensor,
                    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    log_a: torch.Tensor, normalize: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token step.  state (B, H, dk, dv); norm (B, H, dk); q, k
    (B, H, dk); v (B, H, dv); log_a (B, H).  Returns (y (B, H, dv) in
    v.dtype, new state, new norm), the state math in f32."""
    f32 = torch.float32
    a = torch.exp(log_a.to(f32))[..., None, None]
    k32, v32, q32 = k.to(f32), v.to(f32), q.to(f32)
    state = a * state.to(f32) + k32[..., :, None] * v32[..., None, :]
    norm = a[..., 0] * norm.to(f32) + k32
    y = torch.einsum("bhk,bhkv->bhv", q32, state)
    if normalize:
        qn = (q32 * norm).sum(-1)
        y = y / qn.abs().clamp_min(1.0)[..., None]
    return y.to(v.dtype), state, norm
