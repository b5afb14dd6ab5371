"""qwen3-8b — dense decoder, GQA kv=8, qk-norm [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv=8, d_ff=12288,
    d_head=128, vocab=151936, act="silu", qk_norm=True, rope_theta=1e6,
    source="hf:Qwen/Qwen3-8B",
)


def reduced() -> ModelConfig:
    from dataclasses import replace
    return replace(CONFIG, n_layers=2, d_model=64, n_heads=4, n_kv=2,
                   d_head=16, d_ff=192, vocab=512)
