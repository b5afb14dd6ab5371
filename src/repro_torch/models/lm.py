"""The LM stack's parameters and block pieces for the serving slice.

The counterpart of ``src/repro/models/lm.py`` for ``block`` in
{``attn``, ``mlstm``}: pre-norm GQA attention with a gated MLP (qwen3),
and the xLSTM mLSTM block (chunkwise GLA).  Parameters keep the
reference's names (``embed/tokens``, ``lm_head``, ``final_norm/scale``,
``layers/attn/wq``, ``layers/mlstm/w_in``, ...).  The reference stacks each
``layers/...`` entry on a leading layer axis for ``lax.scan``; here layer
``i`` holds its own slice (``LM.layers[i]``, under the name less the
``layers/`` prefix) and the serving loop walks the layers in Python.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..device import resolve_device
from . import layers as L

#: (stacked shape as in the reference, initialiser)
Spec = Tuple[Tuple[int, ...], str]
LAYER_PREFIX = "layers/"


def param_specs(cfg: ModelConfig) -> Dict[str, Spec]:
    """The reference's parameter names and (layer-stacked) shapes."""
    if cfg.block not in ("attn", "mlstm"):
        raise ValueError(f"block {cfg.block!r} is not ported")
    d, hd, h, kv, nl = (cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv,
                        cfg.n_layers)
    vp = cfg.vocab_padded()
    specs: Dict[str, Spec] = {
        "embed/tokens": ((vp, d), "embed"),
        "final_norm/scale": ((d,), "ones"),
        "lm_head": ((vp, d), "embed"),
        "layers/ln1/scale": ((nl, d), "ones"),
    }
    if cfg.block == "attn":
        specs.update({
            "layers/attn/wq": ((nl, d, h * hd), "fan_in"),
            "layers/attn/wk": ((nl, d, kv * hd), "fan_in"),
            "layers/attn/wv": ((nl, d, kv * hd), "fan_in"),
            "layers/attn/wo": ((nl, h * hd, d), "fan_in"),
            "layers/ln2/scale": ((nl, d), "ones"),
            "layers/mlp/w1": ((nl, d, cfg.d_ff), "fan_in"),
            "layers/mlp/w2": ((nl, cfg.d_ff, d), "fan_in"),
            "layers/mlp/w3": ((nl, d, cfg.d_ff), "fan_in"),  # SiLU: gated
        })
        if cfg.qk_norm:
            specs["layers/attn/q_norm"] = ((nl, hd), "ones")
            specs["layers/attn/k_norm"] = ((nl, hd), "ones")
    else:
        di = 2 * d
        dk = di // h
        specs.update({
            "layers/mlstm/w_in": ((nl, d, 2 * di), "fan_in"),
            "layers/mlstm/wq": ((nl, h, dk, dk), "fan_in"),
            "layers/mlstm/wk": ((nl, h, dk, dk), "fan_in"),
            "layers/mlstm/wv": ((nl, h, dk, dk), "fan_in"),
            "layers/mlstm/w_gate": ((nl, d, 2 * h), "gate"),
            "layers/mlstm/w_out": ((nl, di, d), "fan_in"),
        })
    return specs


class LM(nn.Module):
    """One model's parameters: ``top`` holds the unstacked entries,
    ``layers[i]`` layer i's.  Allocated uninitialised on ``device``
    (``None``: the CUDA card) in ``dtype`` (``None``: ``cfg.dtype``)."""

    def __init__(self, cfg: ModelConfig, device=None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        dt = dtype or getattr(torch, cfg.dtype)

        def empty(shape):
            return nn.Parameter(torch.empty(shape, dtype=dt, device=dev),
                                requires_grad=False)

        specs = param_specs(cfg)
        n = len(LAYER_PREFIX)
        self.top = nn.ParameterDict({
            k: empty(s) for k, (s, _) in specs.items()
            if not k.startswith(LAYER_PREFIX)})
        self.layers = nn.ModuleList(nn.ParameterDict({
            k[n:]: empty(s[1:]) for k, (s, _) in specs.items()
            if k.startswith(LAYER_PREFIX)}) for _ in range(cfg.n_layers))

    def tensors(self, name: str):
        """The tensors behind a reference name: one, or one per layer."""
        if name.startswith(LAYER_PREFIX):
            return [p[name[len(LAYER_PREFIX):]] for p in self.layers]
        return [self.top[name]]


def _trunc_normal_(t: torch.Tensor, std: float,
                   gen: torch.Generator) -> None:
    """Fill t with std * N(0, 1) truncated to [-2, 2] (the reference's
    ``trunc_normal``): inverse CDF of a uniform f32 draw on t's device."""
    lo, hi = (0.5 * (1 + math.erf(z / math.sqrt(2))) for z in (-2.0, 2.0))
    u = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    u.uniform_(2 * lo - 1, 2 * hi - 1, generator=gen)
    t.copy_(u.erfinv_().mul_(math.sqrt(2) * std))


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None,
                dtype: Optional[torch.dtype] = None) -> LM:
    """A model with random weights drawn from ``generator`` on ``device``
    (the generator must live there): the reference's initialisers
    (ones; truncated normals of std 0.02 for embeddings and gates and
    1/sqrt(fan in) otherwise), not its random numbers."""
    model = LM(cfg, device, dtype)
    with torch.no_grad():
        for name, (shape, init) in sorted(param_specs(cfg).items()):
            for t in model.tensors(name):
                if init == "ones":
                    t.fill_(1.0)
                elif init in ("embed", "gate"):
                    _trunc_normal_(t, 0.02, generator)
                else:                                   # fan_in
                    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
                    _trunc_normal_(t, 1.0 / math.sqrt(fan_in), generator)
    return model


# -- block pieces (p: one layer's ParameterDict) ------------------------------


def _project_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    """x (B, S, D) -> q (B, S, H, hd), k/v (B, S, KV, hd), qk-normed."""
    hd, h, kv = cfg.head_dim, cfg.n_heads, cfg.n_kv
    q = (x @ p["attn/wq"]).unflatten(-1, (h, hd))
    k = (x @ p["attn/wk"]).unflatten(-1, (kv, hd))
    v = (x @ p["attn/wv"]).unflatten(-1, (kv, hd))
    if cfg.qk_norm:
        q = L.rms_norm(q, p["attn/q_norm"])
        k = L.rms_norm(k, p["attn/k_norm"])
    return q, k, v


def _mlp_sublayer(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    """The gated MLP: act(x w1) * (x w3), then w2."""
    hid = L.act_fn(cfg.act)(x @ p["mlp/w1"]) * (x @ p["mlp/w3"])
    return hid @ p["mlp/w2"]


def _mlstm_qkv(cfg: ModelConfig, p, x: torch.Tensor):
    """mLSTM projections: x (B, S, D) -> q, k, v (B, S, H, dk), log_a
    (B, S, H) f32, z (B, S, 2 D)."""
    h = cfg.n_heads
    dk = 2 * cfg.d_model // h
    xi, z = (x @ p["mlstm/w_in"]).chunk(2, dim=-1)
    xh = xi.unflatten(-1, (h, dk))
    q = torch.einsum("bshk,hkl->bshl", xh, p["mlstm/wq"])
    k = torch.einsum("bshk,hkl->bshl", xh, p["mlstm/wk"]) / math.sqrt(dk)
    v = torch.einsum("bshk,hkl->bshl", xh, p["mlstm/wv"])
    gi, gf = (x @ p["mlstm/w_gate"]).chunk(2, dim=-1)
    log_a = F.logsigmoid(gf.float())
    k = k * torch.sigmoid(gi.float())[..., None].to(k.dtype)
    return q, k, v, log_a, z


def _embed(model: LM, tokens: torch.Tensor) -> torch.Tensor:
    return model.top["embed/tokens"][tokens]


def _unembed(model: LM, x: torch.Tensor) -> torch.Tensor:
    return x @ model.top["lm_head"].T
