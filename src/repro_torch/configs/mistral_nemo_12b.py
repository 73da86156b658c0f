"""mistral-nemo-12b [dense]: 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    vocab=131_072,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    pattern=(BlockSpec("attn", "dense"),),
    n_periods=40,
    rope_theta=1_000_000.0,
    run_long_context=False,   # pure full attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="nemo-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, n_periods=2, dtype="float32",
        remat_policy="none")
