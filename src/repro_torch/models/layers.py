"""Shared model layers: norms, rotary embeddings, the SwiGLU MLP, the
embedding table and the dense head (port of ``repro.models.layers``).

Weights keep the JAX package's (in, out) layout and are applied as
``x @ w``, so a reference parameter copies over without a transpose.  The
arithmetic follows the reference where it decides parity: ``rms_norm``
and the rotary rotation run in float32 and cast back, the dense head
casts its product to float32 after the matmul.

YaRN (arXiv:2309.00071, as DeepSeek-V3's ``DeepseekV3YarnRotaryEmbedding``
computes it): a ``Yarn`` given to ``rope_table`` blends each rotary
frequency with itself divided by ``factor`` through a linear ramp between
the correction dims of ``beta_fast`` and ``beta_slow`` rotations over the
original context, and scales cos and sin by ``attention_factor``; MLA
multiplies its softmax scale by ``softmax_mscale``.  Without one every
table is the plain rope's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.sharding import (fsdp, is_dtensor, local_grads,
                                         shard_offset)
from repro_torch.spans import span


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x * rsqrt(mean(x^2) + eps) * (1 + scale) in float32, cast back to
    x's dtype (scale is stored as scale - 1, so zeros are the identity)."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


def norm_scale(dim: int, device) -> nn.Parameter:
    """A norm's stored (scale - 1), zeros, float32 as the reference keeps
    it whatever the model's dtype."""
    return nn.Parameter(torch.zeros(dim, dtype=torch.float32, device=device))


# ---------------------------------------------------------------- rotary ---

def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's magnitude correction 0.1 * mscale * ln(factor) + 1 (1 for a
    factor of at most 1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


@dataclasses.dataclass(frozen=True)
class Yarn:
    """A YaRN context extension of the rotary tables (see the module
    docstring); DeepSeek-V3's ``rope_scaling`` names the same fields."""
    factor: float
    original_max_position: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0

    def correction_range(self, dim: int, theta: float) -> tuple:
        """The (low, high) frequency indices between which the ramp runs:
        the dims that turn ``beta_fast`` and ``beta_slow`` times over the
        original context, floored and ceiled, within [0, dim - 1]."""
        def at(rotations):
            return dim * math.log(self.original_max_position / (
                rotations * 2 * math.pi)) / (2 * math.log(theta))
        return (max(math.floor(at(self.beta_fast)), 0),
                min(math.ceil(at(self.beta_slow)), dim - 1))

    @property
    def attention_factor(self) -> float:
        """The factor on cos and sin: mscale over mscale_all_dim."""
        return (yarn_mscale(self.factor, self.mscale)
                / yarn_mscale(self.factor, self.mscale_all_dim))

    @property
    def softmax_mscale(self) -> float:
        """The factor on MLA's softmax scale: yarn_mscale(factor,
        mscale_all_dim) squared (1 where mscale_all_dim is 0)."""
        if not self.mscale_all_dim:
            return 1.0
        return yarn_mscale(self.factor, self.mscale_all_dim) ** 2


def rope_frequencies(head_dim: int, theta: float, device=None,
                     yarn: Optional[Yarn] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    if yarn is None:
        return 1.0 / (theta ** exps)
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (yarn.factor * theta ** exps)
    low, high = yarn.correction_range(head_dim, theta)
    ramp = torch.clamp((torch.arange(head_dim // 2, dtype=torch.float32,
                                     device=device) - low)
                       / ((high if high != low else high + 0.001) - low),
                       0, 1)
    mask = 1.0 - ramp
    return inter * (1.0 - mask) + extra * mask


def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               yarn: Optional[Yarn] = None):
    """(cos, sin) of the rotation angles, each (..., S, 1, hd/2) float32,
    for positions (..., S), YaRN's when `yarn` is given.  Computed once per
    forward or decode step and shared by every layer (the reference
    recomputes it in each layer; the values are the same)."""
    freqs = rope_frequencies(head_dim, theta, positions.device, yarn)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]
    if yarn is not None and yarn.attention_factor != 1.0:
        cos, sin = cos * yarn.attention_factor, sin * yarn.attention_factor
    return cos, sin


def rotate(x: torch.Tensor, table) -> torch.Tensor:
    """Apply a ``rope_table`` to x (..., S, H, hd): split halves (not
    interleaved), rotated in float32, cast back to x's dtype."""
    cos, sin = table
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., S, H, hd), positions: (..., S) int -> same shape."""
    return rotate(x, rope_table(positions, x.shape[-1], theta))


# ------------------------------------------------------------------ dense ---

class GatedMLP(nn.Module):
    """SwiGLU: silu(x Wg) * (x Wi) @ Wo."""

    def __init__(self, d_model: int, d_ff: int, *, device, dtype):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.wi = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.wg = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.wo = nn.Parameter(torch.empty(d_ff, d_model, **kw))

    def init_weights(self, gen: torch.Generator) -> None:
        d_model, d_ff = self.wi.shape
        normal_(self.wi, gen, 1.0 / math.sqrt(d_model))
        normal_(self.wg, gen, 1.0 / math.sqrt(d_model))
        normal_(self.wo, gen, 1.0 / math.sqrt(d_ff))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("repro_torch.mlp"):
            return ((F.silu(x @ fsdp(self.wg)) * (x @ fsdp(self.wi)))
                    @ fsdp(self.wo))


# -------------------------------------------------------------- embedding ---

class Embed(nn.Module):
    def __init__(self, vocab: int, d_model: int, *, device, dtype):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d_model, device=device,
                                              dtype=dtype))

    def init_weights(self, gen: torch.Generator) -> None:
        normal_(self.table, gen, 0.02)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if is_dtensor(tokens):
            return _lookup_sharded(fsdp(self.table), tokens)
        return self.table[tokens]


def _lookup_sharded(table, tokens):
    """The vocab-parallel lookup as a shard-local body: each rank gathers
    its rows of tokens from its vocab shard of the table (zeros where a
    token lies in another shard) and the partial rows are summed over the
    vocab shards, exactly (one nonzero term each)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm = table.device_mesh
    rows = [p if p.is_shard(0) else Replicate() for p in tokens.placements]
    tokens = tokens.redistribute(dm, rows)
    split = [a.is_shard() or b.is_shard()
             for a, b in zip(rows, table.placements)]
    tab = local_grads(table, split)
    idx = tokens.to_local() - shard_offset(table, 0)
    inside = (idx >= 0) & (idx < tab.shape[0])
    got = tab[torch.clamp(idx, 0, tab.shape[0] - 1)]
    got = torch.where(inside[..., None], got, torch.zeros_like(got))
    part = [Partial() if b.is_shard(0) else a
            for a, b in zip(rows, table.placements)]
    out = DTensor.from_local(got, dm, part, run_check=False)
    return out.redistribute(dm, rows)


class DenseHead(nn.Module):
    """The standard unembedding: x (..., D) -> (..., V) float32."""

    def __init__(self, d_model: int, vocab: int, *, device, dtype):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_model, vocab, device=device,
                                          dtype=dtype))

    def init_weights(self, gen: torch.Generator) -> None:
        normal_(self.w, gen, 1.0 / math.sqrt(self.w.shape[0]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x @ fsdp(self.w)).float()


@torch.no_grad()
def normal_(p: torch.Tensor, gen: torch.Generator, scale: float) -> None:
    """Fill p with N(0, 1) * scale drawn in float32 from `gen` (on p's
    device), then cast to p's dtype, as the reference draws its weights."""
    draw = torch.randn(p.shape, generator=gen, device=p.device,
                       dtype=torch.float32)
    p.copy_(draw.mul_(scale))
