"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(moe)=2048
vocab=129280, MoE 256e top-8 — MLA (kv_lora 512, q_lora 1536), 1 shared +
256 routed, first 3 layers dense (d_ff 18432), MTP.  [arXiv:2412.19437; hf]

Memory posture for 256 x 16GB v5e training: bf16 params, int8-quantized Adam
moments (optim/adamw.py), full remat — see EXPERIMENTS.md §Dry-run.
Deviation: MTP (the depth-1 multi-token-prediction auxiliary objective) is
omitted — it adds one extra block + head to the TRAINING loss only and does
not change the serving architecture (DESIGN.md §Arch-applicability).
"""

import dataclasses

from repro_torch.configs.base import BlockSpec, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    vocab=129_280,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=192,             # nope 128 + rope 64 (q/k); v_dim 128
    d_ff=18432,               # dense prefix layers
    prefix_pattern=(BlockSpec("mla", "dense"),),
    n_prefix=3,
    pattern=(BlockSpec("mla", "moe"),),
    n_periods=58,
    n_experts=256,
    top_k=8,
    moe_d_ff=2048,
    shared_expert_ff=2048,
    mla_q_lora=1536,
    mla_kv_lora=512,
    mla_nope_dim=128,
    mla_rope_dim=64,
    mla_v_dim=128,
    run_long_context=False,   # full (MLA) attention
)


def smoke_config() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="deepseek-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=48, d_ff=128, n_prefix=1, n_periods=2,
        n_experts=8, top_k=2, moe_d_ff=32, shared_expert_ff=32,
        mla_q_lora=32, mla_kv_lora=16, mla_nope_dim=32, mla_rope_dim=16,
        mla_v_dim=32, dtype="float32", remat_policy="none")
