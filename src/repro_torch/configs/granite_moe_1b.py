"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff(exp)=512
vocab=49155, MoE 32e top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    vocab=49_155,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=64,
    d_ff=0,
    pattern=(BlockSpec("attn", "moe"),),
    n_periods=24,
    n_experts=32,
    top_k=8,
    moe_d_ff=512,
    run_long_context=False,   # pure full attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="granite-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=2, head_dim=16, n_periods=2, n_experts=8, top_k=2,
        moe_d_ff=32, dtype="float32", remat_policy="none")
