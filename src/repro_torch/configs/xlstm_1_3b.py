"""xlstm-1.3b — mLSTM matrix-memory blocks [arXiv:2405.04517].

The 1.3B config uses the mLSTM-dominant xLSTM[1:0] layout (all-mLSTM).
d_ff=0: the mLSTM block is the whole sublayer (2x up-projection, per-head
gates, down-projection).  Its recurrent state makes decode O(1) in
sequence length.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv=4, d_ff=0,
    vocab=50304, block="mlstm", pos="none",
    source="arXiv:2405.04517",
)


def reduced() -> ModelConfig:
    from dataclasses import replace
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=2, n_kv=2,
                   vocab=512)
