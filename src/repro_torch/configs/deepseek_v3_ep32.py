"""deepseek-v3-ep32 [moe, port only]: one chip's share of DeepSeek-V3 under
32-way expert parallelism, for training at its published widths.
[arXiv:2412.19437; hf:deepseek-ai/DeepSeek-V3 config.json]

The cut: each MoE layer's 256 routed experts are spread over 32 chips, 8 a
chip, and this chip holds experts 0-7 (``n_experts`` 8 of
``n_routed_experts`` 256); attention, the router, the shared expert, the
dense layer and the vocabulary are whole on every chip.  Depth: 1 dense
layer (of 3) and 4 MoE layers (of 58); the others lie on further pipeline
stages.  MTP is left out, as in ``deepseek-v3-671b``.  Every width is the
published one, as are the router (sigmoid scores over all 256 experts, a
correction bias, 4 of 8 groups, top-8, ``norm_topk_prob``, scaling 2.5)
and YaRN (factor 40 over 4,096 original positions, ``beta_fast`` 32,
``beta_slow`` 1, ``mscale`` = ``mscale_all_dim`` = 1).  The balance
loss's alpha 1e-4 and the bias update's gamma 1e-3 are the paper's §4.2
pre-training settings; the vocabulary head is LogHD (19 bundles).

Not in the JAX package: the settings live on ``PortModelConfig``, a
subclass of ``ModelConfig``, and the config in the port's own registry
(``repro_torch.configs.PORT_ONLY_NAMES``), so ``ARCH_NAMES`` and every
config shared with the reference stay equal to the reference's.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig
from repro_torch.configs import deepseek_v3_671b


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """A ModelConfig with settings the JAX package has no field for; their
    defaults compute what a plain ModelConfig computes.

    router: "softmax" (top-k over a softmax, the Switch loss) or
    "sigmoid_group" (DeepSeek-V3's: sigmoid scores, a correction bias that
    only chooses, the best ``topk_group`` of ``n_group`` groups by the sum
    of their two best biased scores, top-k among those groups' experts,
    the unbiased scores of the chosen renormalised and scaled by
    ``routed_scaling_factor``; the sequence-wise balance loss at weight
    ``balance_weight``; the bias moved by ``bias_update_rate`` after each
    training step).  ``n_experts`` experts are held, from ``held_offset``
    on, of the ``n_routed_experts`` the router scores (0: every expert is
    held).  ``yarn_factor`` > 0 turns YaRN on for the rotary tables and
    MLA's softmax scale."""
    router: str = "softmax"
    n_routed_experts: int = 0
    held_offset: int = 0
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0
    balance_weight: float = 0.0
    bias_update_rate: float = 0.0
    yarn_factor: float = 0.0
    yarn_original_max_position: int = 4096
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 1.0

    @property
    def n_routed(self) -> int:
        return self.n_routed_experts or self.n_experts

    def _moe_blocks(self) -> int:
        reps = self.n_prefix // max(len(self.prefix_pattern), 1)
        return (sum(b.ffn == "moe" for b in self.prefix_pattern) * reps
                + sum(b.ffn == "moe" for b in self.pattern) * self.n_periods)

    def param_count(self) -> int:
        """The parameters on this chip: the held experts, and the router at
        its full width."""
        return super().param_count() + self._moe_blocks() * self.d_model * (
            self.n_routed - self.n_experts)

    def active_param_count(self) -> float:
        """Active parameters a token: of the held experts, the expected
        share of its top_k choices that lands on them."""
        active = self.top_k * self.n_experts / self.n_routed
        return self.param_count() - self._moe_blocks() * (
            self.n_experts - active) * 3 * self.d_model * self.moe_d_ff


def _extend(cfg: ModelConfig, **changes) -> PortModelConfig:
    base = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return PortModelConfig(**{**base, **changes})


DEEPSEEK_V3_ROUTER = dict(router="sigmoid_group", n_group=8, topk_group=4,
                          routed_scaling_factor=2.5, balance_weight=1e-4,
                          bias_update_rate=1e-3)
DEEPSEEK_V3_YARN = dict(yarn_factor=40.0, yarn_original_max_position=4096,
                        yarn_beta_fast=32.0, yarn_beta_slow=1.0,
                        yarn_mscale=1.0, yarn_mscale_all_dim=1.0)

CONFIG = _extend(deepseek_v3_671b.CONFIG, name="deepseek-v3-ep32",
                 n_prefix=1, n_periods=4, n_experts=8, n_routed_experts=256,
                 head="loghd", **DEEPSEEK_V3_ROUTER, **DEEPSEEK_V3_YARN)


def smoke_config() -> PortModelConfig:
    """CPU size: 4 of 16 experts held, top-4 within 2 of 4 groups."""
    return dataclasses.replace(
        CONFIG, name="deepseek-ep32-smoke", vocab=256, d_model=64, n_heads=4,
        n_kv_heads=4, head_dim=48, d_ff=128, n_prefix=1, n_periods=2,
        n_experts=4, n_routed_experts=16, top_k=4, n_group=4, topk_group=2,
        moe_d_ff=32, shared_expert_ff=32, mla_q_lora=32, mla_kv_lora=16,
        mla_nope_dim=32, mla_rope_dim=16, mla_v_dim=32, dtype="float32",
        remat_policy="none")
