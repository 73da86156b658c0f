"""musicgen-large [audio]: 48L d_model=2048 32H (MHA kv=32) d_ff=8192
vocab=2048 — decoder-only over EnCodec tokens.  [arXiv:2306.05284; hf]

The EnCodec frontend is a STUB: input_specs() supplies precomputed frame
embeddings (the 4-codebook sum is folded into the stub).  The backbone is a
standard MHA decoder; the small 2048-entry vocab is the EnCodec codebook.
"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    vocab=2048,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    pattern=(BlockSpec("attn", "dense"),),
    n_periods=48,
    frontend="audio",
    run_long_context=False,   # pure full attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="musicgen-smoke", vocab=128, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=16, d_ff=128, n_periods=2, dtype="float32",
        remat_policy="none")
