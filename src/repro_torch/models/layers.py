"""Shared model layers: norms, rotary embeddings, the SwiGLU MLP, the
embedding table and the dense head (port of ``repro.models.layers``).

Weights keep the JAX package's (in, out) layout and are applied as
``x @ w``, so a reference parameter copies over without a transpose.  The
arithmetic follows the reference where it decides parity: ``rms_norm``
and the rotary rotation run in float32 and cast back, the dense head
casts its product to float32 after the matmul.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.sharding import (fsdp, is_dtensor, local_grads,
                                         shard_offset)


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

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """(cos, sin) of the rotation angles, each (..., S, 1, hd/2) float32,
    for positions (..., S).  Computed once per forward or decode step and
    shared by every layer (the reference recomputes it in each layer; the
    values are the same)."""
    freqs = rope_frequencies(head_dim, theta, positions.device)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


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
