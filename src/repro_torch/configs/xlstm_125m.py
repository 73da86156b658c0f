"""xlstm-125m [ssm]: 12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (no separate FFN; blocks carry their own up/down projections).
[arXiv:2405.04517; unverified]

Layout: periods of (3 mLSTM + 1 sLSTM) x 3 = 12 blocks.
O(1) recurrent state per token -> runs long_500k.
"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    vocab=50_304,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    pattern=(BlockSpec("mlstm", "none"),) * 3 + (BlockSpec("slstm", "none"),),
    n_periods=3,
    run_long_context=True,    # SSM: sub-quadratic, O(1) decode state
    # recurrent mixers consume the carry sequentially over seq; storing it
    # seq-sharded forces per-chunk regathers inside the scan (measured 3x
    # memory regression) — keep Megatron-style D sharding here
    activation_sharding="d",
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="xlstm-smoke", vocab=256, d_model=64, n_heads=2,
        n_kv_heads=2, head_dim=32, n_periods=1, dtype="float32",
        remat_policy="none")
