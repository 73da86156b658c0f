"""The analytic FLOPs of a decoder LM step: a frozen copy of
``repro_torch/launch/roofline.py::analytic_flops`` and of the parameter
counts of ``repro_torch/configs/base.py::ModelConfig`` it reads, over the
benchmark's own configuration file (a JSON object), not the program's
config class.  Matmul-dominated terms: 2 FLOPs a non-embedding active
parameter a token, causal attention at S * S / 2 pairs, a training step
three times the forward.  Full attention (``attn``) and latent attention
(``mla``: queries and keys of ``mla_nope_dim + mla_rope_dim``, values of
``mla_v_dim`` a head) follow the port's ``analytic_flops``, and an
``mla`` block's parameters its ``ModelConfig.param_count``; ``mamba``,
``mlstm`` and ``slstm`` have no count here.

A chip's share of the experts: ``n_experts`` is the number of experts a
MoE layer holds on this chip, and the optional ``n_routed_experts`` the
router's published width (``n_experts`` where it is absent).  The router
counts ``d_model x n_routed_experts`` parameters, the held experts
``n_experts`` experts' worth, and a token's active routed-expert
parameters are ``top_k x n_experts / n_routed_experts`` experts' worth:
the expected share of its ``top_k`` choices that lands on this chip.
"""

from __future__ import annotations

import math
from types import SimpleNamespace


def model_shape(cfg: dict) -> SimpleNamespace:
    """The sizes of a configuration file's ``model`` object, with its
    layer patterns as objects with ``mixer`` and ``ffn``."""
    ns = SimpleNamespace(**cfg)
    ns.pattern = tuple(SimpleNamespace(**b) for b in cfg.get("pattern", ()))
    ns.prefix_pattern = tuple(SimpleNamespace(**b)
                              for b in cfg.get("prefix_pattern", ()))
    ns.n_prefix = cfg.get("n_prefix", 0)
    ns.shared_expert_ff = cfg.get("shared_expert_ff", 0)
    ns.n_routed_experts = cfg.get("n_routed_experts", cfg.get("n_experts", 0))
    return ns


def loghd_bundles(cfg) -> int:
    return max(1, math.ceil(math.log(cfg.vocab) / math.log(cfg.loghd_k))) \
        + cfg.loghd_extra


def _block_lists(cfg):
    """(blocks, repeats) of the prefix and of the periodic pattern."""
    return ((cfg.prefix_pattern,
             cfg.n_prefix // max(len(cfg.prefix_pattern), 1)),
            (cfg.pattern, cfg.n_periods))


def param_count(cfg) -> int:
    """Analytic parameter count (embeddings + blocks + head) on this chip:
    the held experts, the router at its published width."""
    d = cfg.d_model
    total = cfg.vocab * d
    if cfg.head == "dense":
        total += d * cfg.vocab
    else:
        total += loghd_bundles(cfg) * d + cfg.vocab * loghd_bundles(cfg)

    def block_params(blk) -> int:
        p = 0
        if blk.mixer in ("attn", "attn_local"):
            p += d * cfg.n_heads * cfg.head_dim * 2
            p += d * cfg.n_kv_heads * cfg.head_dim * 2
        elif blk.mixer == "mla":
            p += d * cfg.mla_q_lora
            p += cfg.mla_q_lora * cfg.n_heads * (cfg.mla_nope_dim
                                                 + cfg.mla_rope_dim)
            p += d * (cfg.mla_kv_lora + cfg.mla_rope_dim)
            p += cfg.mla_kv_lora * cfg.n_heads * (cfg.mla_nope_dim
                                                  + cfg.mla_v_dim)
            p += cfg.n_heads * cfg.mla_v_dim * d
        else:
            raise ValueError(f"no parameter count for mixer {blk.mixer!r}")
        if blk.ffn == "dense":
            p += 3 * d * cfg.d_ff
        elif blk.ffn == "moe":
            p += d * cfg.n_routed_experts
            p += cfg.n_experts * 3 * d * cfg.moe_d_ff
            p += 3 * d * cfg.shared_expert_ff
        return p

    for blocks, reps in _block_lists(cfg):
        for blk in blocks:
            total += block_params(blk) * reps
    return total


def active_param_count(cfg) -> float:
    """Active parameters a token (MoE: of the held experts, the share of
    its top_k choices that lands on them)."""
    full = param_count(cfg)
    if not cfg.n_experts:
        return full
    moe_blocks = sum(sum(1 for b in blocks if b.ffn == "moe") * reps
                     for blocks, reps in _block_lists(cfg))
    active = cfg.top_k * cfg.n_experts / cfg.n_routed_experts
    inactive = moe_blocks * (cfg.n_experts - active) * 3 \
        * cfg.d_model * cfg.moe_d_ff
    return full - inactive


def analytic_flops(cfg, seq_len: int, batch: int, kind: str) -> dict:
    """Forward FLOPs, the step's total (train = 3x forward) and the 6 N D
    basis, for `batch` sequences of `seq_len` tokens."""
    s, b = seq_len, batch
    tokens = b * (1 if kind == "decode" else s)
    n_embed = cfg.vocab * cfg.d_model
    matmul = 2.0 * (active_param_count(cfg) - n_embed) * tokens
    attn = 0.0
    for blocks, reps in _block_lists(cfg):
        for blk in blocks:
            if blk.mixer in ("attn", "mla"):
                q_hd = (cfg.mla_nope_dim + cfg.mla_rope_dim
                        if blk.mixer == "mla" else cfg.head_dim)
                v_hd = cfg.mla_v_dim if blk.mixer == "mla" else cfg.head_dim
                if kind == "decode":
                    per_tok = 2.0 * cfg.n_heads * (q_hd + v_hd) * s
                    attn += reps * per_tok * tokens
                else:
                    attn += reps * 2.0 * cfg.n_heads * (q_hd + v_hd) \
                        * b * s * s / 2
            elif blk.mixer == "attn_local":
                w = cfg.local_window
                eff = w if kind == "decode" else min(2 * w, s)
                per_tok = 2.0 * cfg.n_heads * 2 * cfg.head_dim * eff
                attn += reps * per_tok * tokens * (
                    0.5 if kind != "decode" and s <= w else 1.0)
    fwd = matmul + attn
    total = 3.0 * fwd if kind == "train" else fwd
    basis = (6.0 if kind == "train" else 2.0) * (
        active_param_count(cfg) - n_embed) * tokens
    return {"fwd": fwd, "total": total, "model_flops": basis,
            "tokens": tokens}
