"""Model configurations: the architectures the serving slice runs.

``ModelConfig`` holds the fields of the reference's
``src/repro/configs/base.py::ModelConfig`` that the attention (dense GQA)
and mLSTM families read.  The other families (MoE, hybrid, encoder-decoder,
vision) and the sharding plans are not ported yet.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    act: str = "silu"           # the only ported activation
    qk_norm: bool = False
    pos: str = "rope"           # rope | none
    rope_theta: float = 1e6
    block: str = "attn"         # attn | mlstm
    dtype: str = "bfloat16"     # parameter and cache type
    source: str = ""            # provenance note

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def vocab_padded(self, mult: int = 16) -> int:
        return -(-self.vocab // mult) * mult

    def param_counts(self) -> Dict[str, int]:
        """Parameters in total and active per token (equal: no MoE), by the
        reference's accounting."""
        d, hd = self.d_model, self.head_dim
        h, kv, ff = self.n_heads, self.n_kv, self.d_ff
        if self.block == "mlstm":
            per_layer = (d * (2 * d) * 2 + 2 * d * (2 * d)
                         + 2 * d * 2 * self.n_heads + 2 * d)
        elif self.block == "attn":
            attn = d * h * hd + 2 * d * kv * hd + h * hd * d
            per_layer = attn + 3 * d * ff + 2 * d          # gated MLP
        else:
            raise ValueError(f"block {self.block!r} is not ported")
        total = self.n_layers * per_layer + 2 * self.vocab * d + d
        return {"total": int(total), "active": int(total)}


#: the architectures ported so far
ARCH_IDS = ("qwen3-8b", "xlstm-1.3b")

_MODULES = {"qwen3-8b": "qwen3_8b", "xlstm-1.3b": "xlstm_1_3b"}


def _module(arch: str):
    if arch not in _MODULES:
        raise ValueError(f"unknown or unported arch {arch!r}; ported: "
                         f"{', '.join(ARCH_IDS)}")
    return importlib.import_module(f"{__package__}.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_reduced(arch: str) -> ModelConfig:
    """Smoke-test variant: same family and topology, tiny widths."""
    return _module(arch).reduced()
