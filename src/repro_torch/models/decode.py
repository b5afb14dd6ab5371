"""Serving path: cache, prefill and one greedy decode step.

The counterpart of ``src/repro/models/decode.py`` for ``block`` in
{``attn``, ``mlstm``}, with the reference's cache layout (leading layer
axis):

  * attn:  k, v (L, B, Smax, KV, hd) in ``cfg.dtype``, K stored after
    RoPE, and ``pos``, the number of positions written;
  * mlstm: GLA state (L, B, H, dk, dk) and normaliser (L, B, H, dk), f32.

Prefill runs attention through the flash-attention kernel (K5) and the
mLSTM through the GLA kernel (K6); ``kernels=False`` runs both through
their plain versions instead (the reference run on the card).
``decode_step`` updates the cache in place, where the reference returns a
new one: a step writes one position (attn) or replaces the state (mlstm).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L
from .lm import LM, _embed, _mlp_sublayer, _mlstm_qkv, _project_qkv, _unembed
from .ssm import chunkwise_gla, gla_decode_step


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device=None) -> Dict[str, object]:
    """An empty cache for ``batch`` sequences of up to ``max_len``
    positions."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.dtype)
    nl, kv, hd, h = cfg.n_layers, cfg.n_kv, cfg.head_dim, cfg.n_heads
    cache: Dict[str, object] = {"pos": 0}
    if cfg.block == "attn":
        for name in ("k", "v"):
            cache[name] = torch.zeros(nl, batch, max_len, kv, hd, dtype=dt,
                                      device=dev)
    elif cfg.block == "mlstm":
        dk = 2 * cfg.d_model // h
        cache["state"] = torch.zeros(nl, batch, h, dk, dk,
                                     dtype=torch.float32, device=dev)
        cache["norm"] = torch.zeros(nl, batch, h, dk, dtype=torch.float32,
                                    device=dev)
    else:
        raise ValueError(f"block {cfg.block!r} is not ported")
    return cache


def _decode_gqa(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, length: int) -> torch.Tensor:
    """Grouped decode attention over the first ``length`` cache positions,
    without repeating KV.  q (B, 1, H, hd); cache (B, S, KV, hd)."""
    b, _, h, hd = q.shape
    kv = k_cache.shape[2]
    kc, vc = k_cache[:, :length], v_cache[:, :length]
    qg = q.reshape(b, kv, h // kv, hd)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), kc.float()) \
        / math.sqrt(hd)
    p = torch.softmax(logits, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(vc.dtype), vc)
    return o.reshape(b, 1, h, hd)


def _final_logits(model: LM, x: torch.Tensor) -> torch.Tensor:
    """Last position's logits (B, Vp)."""
    x = L.rms_norm(x[:, -1:], model.top["final_norm/scale"])
    return _unembed(model, x)[:, 0]


def prefill(model: LM, tokens: torch.Tensor, max_len: int, *,
            kernels: bool = True) -> Tuple[Dict[str, object], torch.Tensor]:
    """Run the prompt (B, S), build the cache; returns (cache, last
    position's logits (B, Vp))."""
    cfg = model.cfg
    b, seq = tokens.shape
    if max_len < seq:
        raise ValueError(f"cache max_len {max_len} < prompt length {seq}")
    dev = tokens.device
    x = _embed(model, tokens)
    cache = init_cache(cfg, b, max_len, dev)
    rope = None
    if cfg.pos == "rope":
        rope = L.rope_tables(torch.arange(seq, device=dev), cfg.head_dim,
                             cfg.rope_theta)
    for i, p in enumerate(model.layers):
        h = L.rms_norm(x, p["ln1/scale"])
        if cfg.block == "attn":
            q, k, v = _project_qkv(cfg, p, h)
            if rope is not None:
                q, k = L.apply_rope(q, *rope), L.apply_rope(k, *rope)
            o = L.attention(q, k, v, causal=True, kernels=kernels)
            x = x + o.flatten(2) @ p["attn/wo"]
            cache["k"][i, :, :seq] = k
            cache["v"][i, :, :seq] = v
            x = x + _mlp_sublayer(cfg, p, L.rms_norm(x, p["ln2/scale"]))
        else:
            q, k, v, log_a, z = _mlstm_qkv(cfg, p, h)
            y, (st, nm) = chunkwise_gla(q, k, v, log_a, chunk=min(128, seq),
                                        kernels=kernels)
            x = x + (y.flatten(2) * F.silu(z)) @ p["mlstm/w_out"]
            cache["state"][i] = st
            cache["norm"][i] = nm
    cache["pos"] = seq
    return cache, _final_logits(model, x)


def decode_step(model: LM, cache: Dict[str, object], token: torch.Tensor
                ) -> Tuple[Dict[str, object], torch.Tensor, torch.Tensor]:
    """One token (B, 1) for the whole batch: updates ``cache`` in place;
    returns (cache, logits (B, Vp), greedy next token (B, 1))."""
    cfg = model.cfg
    pos = cache["pos"]
    x = _embed(model, token)
    rope = None
    if cfg.pos == "rope":
        rope = L.rope_tables(torch.tensor([pos], device=token.device),
                             cfg.head_dim, cfg.rope_theta)
    for i, p in enumerate(model.layers):
        h = L.rms_norm(x, p["ln1/scale"])
        if cfg.block == "attn":
            q, k, v = _project_qkv(cfg, p, h)
            if rope is not None:
                q, k = L.apply_rope(q, *rope), L.apply_rope(k, *rope)
            kc, vc = cache["k"][i], cache["v"][i]
            kc[:, pos] = k[:, 0]
            vc[:, pos] = v[:, 0]
            o = _decode_gqa(q, kc, vc, pos + 1)
            x = x + o.flatten(2) @ p["attn/wo"]
            x = x + _mlp_sublayer(cfg, p, L.rms_norm(x, p["ln2/scale"]))
        else:
            q, k, v, log_a, z = _mlstm_qkv(cfg, p, h)
            y, st, nm = gla_decode_step(cache["state"][i], cache["norm"][i],
                                        q[:, 0], k[:, 0], v[:, 0],
                                        log_a[:, 0])
            cache["state"][i] = st
            cache["norm"][i] = nm
            x = x + (y.flatten(1)[:, None] * F.silu(z)) @ p["mlstm/w_out"]
    cache["pos"] = pos + 1
    logits = _final_logits(model, x)
    return cache, logits, logits.argmax(-1, keepdim=True).to(token.dtype)
