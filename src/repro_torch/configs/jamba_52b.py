"""jamba-v0.1-52b [hybrid]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, MoE 16e top-2 — Mamba+attn 1:7 interleave, MoE every other
layer.  [arXiv:2403.19887; hf]

Period of 8: mamba at 0-3 & 5-7, attention at 4; MoE on odd positions.
Sub-quadratic bulk (mamba) + 4 attention layers with sequence-sharded
distributed flash-decode -> runs long_500k.
"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

_PERIOD = (
    BlockSpec("mamba", "dense"),
    BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"),
    BlockSpec("mamba", "moe"),
    BlockSpec("attn", "dense"),
    BlockSpec("mamba", "moe"),
    BlockSpec("mamba", "dense"),
    BlockSpec("mamba", "moe"),
)

CONFIG = ModelConfig(
    name="jamba-v0.1-52b",
    vocab=65_536,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    pattern=_PERIOD,
    n_periods=4,
    n_experts=16,
    top_k=2,
    moe_d_ff=14336,
    run_long_context=True,    # hybrid: mamba bulk + seq-sharded attn decode
    # mamba's conv + selective scan are sequential over seq: seq-sharded
    # carry storage regressed memory ~10x (EXPERIMENTS.md §Perf #11) — use
    # D sharding for the hybrid stack
    activation_sharding="d",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="jamba-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, d_ff=128, n_periods=1, n_experts=4,
        top_k=2, moe_d_ff=64, dtype="float32", remat_policy="none")
