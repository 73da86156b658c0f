"""ModelConfig: the declarative description of every assigned architecture,
plus the assigned input-shape suite."""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One position in the periodic layer pattern."""
    mixer: Literal["attn", "attn_local", "mla", "mamba", "mlstm", "slstm"]
    ffn: Literal["dense", "moe", "none"] = "dense"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    # layer layout: prefix (unrolled) + pattern x n_periods
    pattern: Tuple[BlockSpec, ...] = (BlockSpec("attn", "dense"),)
    n_periods: int = 1
    prefix_pattern: Tuple[BlockSpec, ...] = ()
    n_prefix: int = 0
    # attention details
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    local_window: int = 1024
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0
    # MLA (deepseek)
    mla_q_lora: int = 1536
    mla_kv_lora: int = 512
    mla_nope_dim: int = 128
    mla_rope_dim: int = 64
    mla_v_dim: int = 128
    # head: "dense" or "loghd" (the paper's class-axis compression at vocab
    # scale); loghd_k/extra control n = ceil(log_k V) + extra
    head: str = "dense"
    loghd_k: int = 2
    loghd_extra: int = 2
    # frontend stub: None (token LM) | "vlm" | "audio" — input_specs supplies
    # precomputed embeddings for the stubbed modality
    frontend: Optional[str] = None
    # numerics / memory
    dtype: str = "bfloat16"
    remat_policy: str = "full"          # none | dots | full
    scale_embed: bool = False
    loss_chunk: int = 512               # seq-chunked CE (0 = whole-seq);
                                        # bounds the (B, chunk, V) logits
                                        # transient that dominates HBM at
                                        # 128k+ vocabs
    activation_sharding: str = "seq"    # how the layer-scan carry is stored:
                                        # "seq" (sequence-parallel: seq on
                                        # "model"; MLP needs no regather),
                                        # "d" (D on "model"), "none"
    # which shapes this arch runs (long_500k only for sub-quadratic archs)
    run_long_context: bool = False

    @property
    def n_layers(self) -> int:
        return self.n_prefix + len(self.pattern) * self.n_periods

    @property
    def loghd_bundles(self) -> int:
        return max(1, math.ceil(math.log(self.vocab) /
                                math.log(self.loghd_k))) + self.loghd_extra

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d = self.d_model
        total = self.vocab * d                       # embed
        if self.head == "dense":
            total += d * self.vocab
        else:
            total += self.loghd_bundles * d + self.vocab * self.loghd_bundles

        def block_params(blk: BlockSpec) -> int:
            p = 0
            if blk.mixer in ("attn", "attn_local"):
                p += d * self.n_heads * self.head_dim * 2   # wq, wo
                p += d * self.n_kv_heads * self.head_dim * 2
            elif blk.mixer == "mla":
                p += d * self.mla_q_lora
                p += self.mla_q_lora * self.n_heads * (self.mla_nope_dim + self.mla_rope_dim)
                p += d * (self.mla_kv_lora + self.mla_rope_dim)
                p += self.mla_kv_lora * self.n_heads * (self.mla_nope_dim + self.mla_v_dim)
                p += self.n_heads * self.mla_v_dim * d
            elif blk.mixer == "mamba":
                di = 2 * d
                p += d * 2 * di + di * (math.ceil(d / 16) + 32) \
                    + math.ceil(d / 16) * di + di * d + di * 16 + 5 * di
            elif blk.mixer == "mlstm":
                di = 2 * d
                p += d * 2 * di + 3 * di * di + 2 * di * self.n_kv_heads + di * d
            elif blk.mixer == "slstm":
                p += 8 * d * d + d * 2 * d + 2 * d * d
            if blk.ffn == "dense":
                p += 3 * d * self.d_ff
            elif blk.ffn == "moe":
                p += d * self.n_experts
                p += self.n_experts * 3 * d * self.moe_d_ff
                p += 3 * d * self.shared_expert_ff
            return p

        for blk in self.prefix_pattern:
            total += block_params(blk) * (self.n_prefix // max(len(self.prefix_pattern), 1))
        for blk in self.pattern:
            total += block_params(blk) * self.n_periods
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        full = self.param_count()
        moe_blocks = sum(1 for b in self.pattern if b.ffn == "moe") * self.n_periods
        moe_blocks += sum(1 for b in self.prefix_pattern if b.ffn == "moe") * (
            self.n_prefix // max(len(self.prefix_pattern), 1))
        inactive = moe_blocks * (self.n_experts - self.top_k) * 3 * \
            self.d_model * self.moe_d_ff
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


# The assigned input-shape suite (same for all 10 archs; long_500k gated by
# cfg.run_long_context per the sub-quadratic requirement).
SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}
