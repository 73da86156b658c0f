"""qwen1.5-4b [dense]: 40L d_model=2560 20H (GQA kv=20 = MHA) d_ff=6912
vocab=151936 — QKV bias.  [hf:Qwen/Qwen1.5-4B; hf]"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    vocab=151_936,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    head_dim=128,
    d_ff=6912,
    pattern=(BlockSpec("attn", "dense"),),
    n_periods=40,
    qkv_bias=True,
    rope_theta=5_000_000.0,
    run_long_context=False,   # pure full attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen15-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, n_periods=2, dtype="float32",
        remat_policy="none")
