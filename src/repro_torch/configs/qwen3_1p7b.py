"""qwen3-1.7b [dense]: 28L d_model=2048 16H (GQA kv=8) d_ff=6144
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B family; hf]"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    vocab=151_936,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    pattern=(BlockSpec("attn", "dense"),),
    n_periods=28,
    qk_norm=True,
    rope_theta=1_000_000.0,
    run_long_context=False,   # pure full attention: long_500k skipped
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, n_periods=2, dtype="float32",
        remat_policy="none")
