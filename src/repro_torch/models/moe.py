"""Mixture-of-Experts ffn (port of ``repro.models.moe``'s single-device
path, ``_local_moe`` without its collectives).

Used by deepseek-v3 (256 routed experts and one shared, top-8),
granite-moe (32 experts, top-8) and jamba (16 experts, top-2).

Routing is top-k over the softmax of a float32 router (the contraction in
x's dtype, its result cast to float32), ties to the lower expert index;
the k gates are renormalised by max(sum, 1e-9).  The Switch
load-balancing loss is ``router_aux_weight * E * sum_e mean_prob_e *
mean_count_e``.  Each expert takes at most ``cap = ceil(capacity_factor *
T * top_k / E)`` tokens of the call's T, in the order of the token-major
flattened (T * k) choices; a token past its expert's capacity falls
through the residual.  The kept tokens are scattered into (E, cap, D)
buffers, every expert runs its SwiGLU on its whole buffer (dense batched
products, as the reference computes them outside any kernel), and each
token's k outputs are gathered back and summed with their gates.

The capacity counts every token of the call, so a decode step (T = B)
and a forward (T = B * S) can drop different tokens, in the reference
too; with ``capacity_factor = E / top_k`` nothing is dropped.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import normal_

_NO_MESH = ("a mesh: the LM sharding rules (models/sharding.py) are not "
            "ported yet (ROADMAP queue 1, item 5)")


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    d_ff: int                    # per-expert hidden
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    shared_expert_ff: int = 0    # deepseek: one always-on shared expert
    router_aux_weight: float = 0.01

    def capacity(self, tokens: int) -> int:
        """Slots per expert for a call of `tokens` tokens
        (``moe.py:97``, the same float expression)."""
        return max(1, int(math.ceil(self.capacity_factor * tokens
                                    * self.top_k / self.n_experts)))


@dataclasses.dataclass(frozen=True)
class Routing:
    """One call's routing: the (T, k) chosen experts, their renormalised
    gates, each choice's slot in its expert's buffer and whether it fits
    under the capacity, and the auxiliary loss."""
    experts: torch.Tensor        # (T, k) int64
    gates: torch.Tensor          # (T, k) float32
    slots: torch.Tensor          # (T * k,) int64, cap - 1 where dropped
    keep: torch.Tensor           # (T * k,) bool
    cap: int
    aux: torch.Tensor            # () float32


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values in
    descending order, equal values in the order of their indices."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    """Parameters in the reference's layout: router (D, E) float32, wi / wg
    (E, D, F), wo (E, F, D), and with a shared expert shared_wi /
    shared_wg (D, Fs), shared_wo (Fs, D)."""

    def __init__(self, cfg: MoEConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
        self.router = nn.Parameter(torch.empty(d, e, device=device,
                                               dtype=torch.float32))
        self.wi = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wg = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))
        if cfg.shared_expert_ff:
            fs = cfg.shared_expert_ff
            self.shared_wi = nn.Parameter(torch.empty(d, fs, **kw))
            self.shared_wg = nn.Parameter(torch.empty(d, fs, **kw))
            self.shared_wo = nn.Parameter(torch.empty(fs, d, **kw))

    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales (``moe.py:45-59``).  Expert leaves are
        drawn one expert at a time, so the float32 draft of a draw is one
        expert's (deepseek's (256, 7168, 2048) leaf would need 15 GB)."""
        s_in = 1.0 / math.sqrt(self.cfg.d_model)
        s_out = 1.0 / math.sqrt(self.cfg.d_ff)
        normal_(self.router, gen, s_in)
        for w, s in ((self.wi, s_in), (self.wg, s_in), (self.wo, s_out)):
            for e in range(w.shape[0]):
                normal_(w[e], gen, s)
        if self.cfg.shared_expert_ff:
            normal_(self.shared_wi, gen, s_in)
            normal_(self.shared_wg, gen, s_in)
            normal_(self.shared_wo, gen,
                    1.0 / math.sqrt(self.cfg.shared_expert_ff))

    def route(self, x: torch.Tensor) -> Routing:
        """Routing of x (T, D) (``moe.py:83-103``)."""
        cfg = self.cfg
        t, e = x.shape[0], cfg.n_experts
        logits = (x @ self.router.to(x.dtype)).float()
        probs = torch.softmax(logits, dim=-1)
        gates, experts = top_k(probs, cfg.top_k)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        me = probs.mean(0)
        ce = F.one_hot(experts, e).float().sum(1).mean(0)
        aux = cfg.router_aux_weight * e * (me * ce).sum()
        cap = cfg.capacity(t)
        flat = experts.reshape(-1)                             # (T*K,)
        onehot = F.one_hot(flat, e)                            # (T*K, E)
        slot = onehot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1
        keep = slot < cap
        return Routing(experts, gates, torch.where(keep, slot, cap - 1),
                       keep, cap, aux)

    def experts_ffn(self, buf: torch.Tensor) -> torch.Tensor:
        """Every expert's SwiGLU over its (cap, D) buffer: (E, cap, D)."""
        g = F.silu(torch.bmm(buf, self.wg))
        return torch.bmm(g * torch.bmm(buf, self.wi), self.wo)

    def forward(self, x: torch.Tensor):
        """x (B, S, D) -> (y (B, S, D), aux loss () float32)."""
        cfg = self.cfg
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        r = self.route(xt)
        flat = r.experts.reshape(-1)
        keep = r.keep[:, None]
        x_rep = torch.repeat_interleave(xt, cfg.top_k, dim=0)  # (T*K, D)
        # a dropped choice adds zeros to its expert's last slot: the
        # reference's scatter-add, a plain copy for every kept token
        buf = xt.new_zeros((cfg.n_experts, r.cap, d)).index_put(
            (flat, r.slots), torch.where(keep, x_rep, 0), accumulate=True)
        out = self.experts_ffn(buf)
        y_tok = torch.where(keep, out[flat, r.slots], 0)
        y = (y_tok.reshape(-1, cfg.top_k, d)
             * r.gates[..., None].to(y_tok.dtype)).sum(1)
        if cfg.shared_expert_ff:
            sg = F.silu(xt @ self.shared_wg)
            y = y + (sg * (xt @ self.shared_wi)) @ self.shared_wo
        return y.reshape(b, s, d), r.aux


def moe_block(moe: MoE, x: torch.Tensor, mesh: Optional[object] = None):
    """The reference's ``moe_block`` entry: ``moe(x)`` on one device; a
    mesh (expert parallelism) raises until the LM sharding is ported."""
    if mesh is not None:
        raise NotImplementedError(f"moe_block with {_NO_MESH}")
    return moe(x)
