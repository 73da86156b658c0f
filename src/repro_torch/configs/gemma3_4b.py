"""gemma3-4b [dense]: 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144 — 5:1 local:global sliding window, 128k ctx.
[hf:google/gemma-3-4b-pt; unverified]

Layer layout: periods of (5 local + 1 global); 34 layers ~ 5 periods of 6
plus a 4-layer prefix (4 local) to land exactly on 34.
"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    vocab=262_144,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    prefix_pattern=(BlockSpec("attn_local", "dense"),),
    n_prefix=4,
    pattern=(BlockSpec("attn_local", "dense"),) * 5
    + (BlockSpec("attn", "dense"),),
    n_periods=5,
    local_window=1024,
    rope_theta=1_000_000.0,
    scale_embed=True,
    # 1-in-6 layers is full global attention -> not sub-quadratic overall;
    # long_500k skipped (DESIGN.md §Arch-applicability)
    run_long_context=False,
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="gemma3-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, n_prefix=1, n_periods=1,
        local_window=32, dtype="float32", remat_policy="none")
