"""GQA / MHA attention: full causal, sliding-window (two-block banded) and
one-token decode against a KV cache with per-slot positions (port of
``repro.models.attention`` without ``decode_attention_seqsharded``).

Variants: grouped KV heads, qk-norm (per-head RMSNorm on q and k before the
rotation), QKV bias, and the sliding window of local layers.

The arithmetic follows the reference: logits are the einsum in the
activations' dtype cast to float32, scaled, masked with ``NEG_INF``,
softmaxed in float32, and the probabilities cast to the value dtype before
the PV product.  Einsums, not ``scaled_dot_product_attention``, whose
masking and precision differ.  Queries are processed in chunks of
``ATTN_CHUNK`` rows, as the reference bounds its (B, H, chunk, T) logits,
each chunk recomputed in the backward when autograd records.

The decode cache is updated in place: a step writes its token's k and v
into the cache tensors it is given (the reference returns a new cache).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import norm_scale, normal_, rms_norm, rotate

NEG_INF = -2.0 ** 30
ATTN_CHUNK = 512  # q-chunk size for memory-efficient attention


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None          # sliding window (local layers)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, T, KV, hd) -> (B, T, KV*groups, hd): head h reads KV head
    h // groups, as ``jnp.repeat`` along the head axis."""
    return k if groups == 1 else torch.repeat_interleave(k, groups, dim=2)


def _softmax_pv(logits: torch.Tensor, v: torch.Tensor,
                eq: str) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum(eq, probs, v)


def _sdpa(q, k, v, scale: float, *, causal: bool = True,
          chunk: int = ATTN_CHUNK) -> torch.Tensor:
    """Causal attention.  q: (B, S, H, hd), k / v: (B, T, KV, hd) grouped.
    Returns (B, S, H * hd)."""
    b, s, h, hd = q.shape
    groups = h // k.shape[2]
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    kpos = torch.arange(k.shape[1], device=q.device)

    def attend(qc, qpos):
        logits = torch.einsum("bshd,bthd->bhst", qc, k).float() * scale
        if causal:
            mask = kpos[None, :] <= qpos[:, None]          # (C, T)
            logits = torch.where(mask[None, None], logits, NEG_INF)
        return _softmax_pv(logits, v, "bhst,bthd->bshd")

    if s <= chunk:
        out = attend(q, torch.arange(s, device=q.device))
    else:
        if s % chunk:
            raise ValueError(f"seq {s} must be a multiple of {chunk}")
        if torch.is_grad_enabled():
            # recompute each chunk in the backward, as the reference's
            # checkpointed scan does: otherwise autograd keeps every
            # chunk's (B, H, chunk, T) logits and probabilities
            plain = attend

            def attend(qc, qpos):
                return checkpoint(plain, qc, qpos, use_reentrant=False,
                                  preserve_rng_state=False)
        out = torch.cat([
            attend(q[:, c:c + chunk], torch.arange(c, c + chunk,
                                                   device=q.device))
            for c in range(0, s, chunk)], dim=1)
    return out.reshape(b, s, h * v.shape[-1])


class Attention(nn.Module):
    """Parameters in the reference's layout: wq (D, H*hd), wk / wv
    (D, KV*hd), wo (H*hd, D), optional biases bq / bk / bv, optional
    qnorm / knorm (hd,) float32."""

    def __init__(self, cfg: AttnConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d, qd, kvd = (cfg.d_model, cfg.n_heads * cfg.head_dim,
                      cfg.n_kv_heads * cfg.head_dim)
        self.wq = nn.Parameter(torch.empty(d, qd, **kw))
        self.wk = nn.Parameter(torch.empty(d, kvd, **kw))
        self.wv = nn.Parameter(torch.empty(d, kvd, **kw))
        self.wo = nn.Parameter(torch.empty(qd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(qd, **kw))
            self.bk = nn.Parameter(torch.zeros(kvd, **kw))
            self.bv = nn.Parameter(torch.zeros(kvd, **kw))
        if cfg.qk_norm:
            self.qnorm = norm_scale(cfg.head_dim, device)
            self.knorm = norm_scale(cfg.head_dim, device)

    def init_weights(self, gen: torch.Generator) -> None:
        s = 1.0 / math.sqrt(self.cfg.d_model)
        for w in (self.wq, self.wk, self.wv):
            normal_(w, gen, s)
        normal_(self.wo, gen,
                1.0 / math.sqrt(self.cfg.n_heads * self.cfg.head_dim))

    def qkv(self, x: torch.Tensor, rope):
        """x (B, S, D) -> q (B, S, H, hd), k / v (B, S, KV, hd), with qk-norm
        and the rotation of `rope` (a ``layers.rope_table``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        if cfg.qk_norm:
            q = rms_norm(q, self.qnorm)
            k = rms_norm(k, self.knorm)
        return rotate(q, rope), rotate(k, rope), v

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        """Prefill / training attention over x (B, S, D): full causal, or
        banded for a local layer."""
        if self.cfg.window is not None and x.shape[1] > self.cfg.window:
            return self._local(x, rope)
        q, k, v = self.qkv(x, rope)
        return _sdpa(q, k, v, 1.0 / math.sqrt(self.cfg.head_dim)) @ self.wo

    def _local(self, x: torch.Tensor, rope) -> torch.Tensor:
        """Sliding-window attention in the chunked two-block banded form:
        each chunk of w queries attends to itself and the previous chunk
        under the causal + window mask.  Exact for window <= w."""
        cfg = self.cfg
        w = cfg.window
        b, s, _ = x.shape
        if s % w:
            raise ValueError(f"seq {s} must be a multiple of window {w}")
        q, k, v = self.qkv(x, rope)
        nc = s // w
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

        def chunk(t):  # (B, S, H, hd) -> (B, nc, w, H, hd)
            return t.reshape(b, nc, w, t.shape[2], hd)

        def prev(t):   # the previous chunk, zeros for the first (masked)
            return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)

        qc, kc, vc = chunk(q), chunk(k), chunk(v)
        k2 = torch.cat([prev(kc), kc], dim=2)          # (B, nc, 2w, KV, hd)
        v2 = torch.cat([prev(vc), vc], dim=2)
        dev = x.device
        qi = torch.arange(w, device=dev)[:, None]
        kj = torch.arange(2 * w, device=dev)[None, :] - w
        base = (kj <= qi) & (kj > qi - w)                  # (w, 2w)
        first = base & (kj >= 0)                           # chunk 0: no prev
        mask = torch.where(torch.arange(nc, device=dev)[:, None, None] == 0,
                           first[None], base[None])        # (nc, w, 2w)
        groups = h // kvh
        k2 = _repeat_kv(k2.reshape(b * nc, 2 * w, kvh, hd), groups)
        v2 = _repeat_kv(v2.reshape(b * nc, 2 * w, kvh, hd), groups)
        k2 = k2.reshape(b, nc, 2 * w, h, hd)
        v2 = v2.reshape(b, nc, 2 * w, h, hd)
        logits = torch.einsum("bcshd,bcthd->bchst", qc, k2).float()
        logits = logits * (1.0 / math.sqrt(hd))
        logits = torch.where(mask[None, :, None], logits, NEG_INF)
        out = _softmax_pv(logits, v2, "bchst,bcthd->bcshd")
        return out.reshape(b, s, h * hd) @ self.wo

    def decode(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               rope, where: "DecodeIndex") -> torch.Tensor:
        """One-token step.  x (B, 1, D); ck / cv (B, L, KV, hd), written in
        place at ``where.slot``; returns (B, 1, D)."""
        cfg = self.cfg
        b = x.shape[0]
        q, k, v = self.qkv(x, rope)
        rows = torch.arange(b, device=x.device)
        ck[rows, where.slot] = k[:, 0]
        cv[rows, where.slot] = v[:, 0]
        h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        qg = q.reshape(b, 1, kvh, h // kvh, hd)
        logits = torch.einsum("bskgd,btkd->bkgst", qg, ck).float()
        logits = logits * (1.0 / math.sqrt(hd))
        logits = torch.where(where.valid[:, None, None, None, :], logits,
                             NEG_INF)
        out = _softmax_pv(logits, cv, "bkgst,btkd->bskgd")
        return out.reshape(b, 1, h * hd) @ self.wo


@dataclasses.dataclass(frozen=True)
class DecodeIndex:
    """Where a decode step writes and which keys it may read, per slot:
    ``slot`` (B,) is min(pos, L - 1) for a global layer and pos mod L (a
    ring) for a local one; ``valid`` (B, L) masks the keys."""
    slot: torch.Tensor
    valid: torch.Tensor

    @classmethod
    def of(cls, pos: torch.Tensor, length: int, local: bool) -> "DecodeIndex":
        idx = torch.arange(length, device=pos.device)[None, :]
        if local:
            valid = ((idx <= torch.clamp(pos, max=length - 1)[:, None])
                     | (pos[:, None] >= length))
            return cls(torch.remainder(pos, length), valid)
        return cls(torch.clamp(pos, max=length - 1), idx <= pos[:, None])


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                  device, *, layers: int = 1) -> dict:
    """Zero k and v caches (layers, B, L, KV, hd), one per stacked layer: a
    full cache (L = max_len) for global layers, a ring of the window for
    local ones."""
    length = min(max_len, cfg.window) if cfg.window else max_len
    shape = (layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
