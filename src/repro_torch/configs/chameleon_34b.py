"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 — early-fusion, VQ image tokens.  [arXiv:2405.09818; unverified]

The modality frontend is a STUB: input_specs() supplies precomputed VQ-token
embeddings (B, S, D) alongside the text path; the backbone is a standard
decoder over the fused stream.
"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    vocab=65_536,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    pattern=(BlockSpec("attn", "dense"),),
    n_periods=48,
    qk_norm=True,             # chameleon uses qk-norm for stability
    frontend="vlm",
    run_long_context=False,   # pure full attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="chameleon-smoke", vocab=256, d_model=64, n_heads=8,
        n_kv_heads=2, head_dim=8, d_ff=128, n_periods=2, dtype="float32",
        remat_policy="none")
