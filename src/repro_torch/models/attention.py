"""GQA / MHA attention: full causal, sliding-window (two-block banded),
one-token decode against a KV cache with per-slot positions, and the
sequence-sharded flash decode of long contexts (port of
``repro.models.attention``).

Variants: grouped KV heads, qk-norm (per-head RMSNorm on q and k before the
rotation), QKV bias, and the sliding window of local layers.

The core of full attention (``_sdpa``) takes one of two paths, by what
the call's tensors are.  CUDA bf16 tensors whose (d, dv) widths the
``kernels.flash_attn`` kernels are compiled for go to that fused kernel
(forward and backward; float32 scores and softmax statistics, bf16
operands, nothing of size S x T in device memory).  Everything else (CPU
tensors, other widths such as gemma3's 256, float32) takes the einsum
path, which follows the reference: logits are the einsum in the
activations' dtype cast to float32, scaled, masked with ``NEG_INF``,
softmaxed in float32, and the probabilities cast to the value dtype before
the PV product, queries in chunks of ``ATTN_CHUNK`` rows as the reference
bounds its (B, H, chunk, T) logits, each chunk recomputed in the backward
when autograd records.  ``SDPA_PATHS`` counts the calls by path.

The decode cache is updated in place: a step writes its token's k and v
into the cache tensors it is given (the reference returns a new cache).

Under a context mesh (``models/sharding.py``) the activations are
DTensors: the reference's hints pin q, k, v and the logits to the head
axis on "model" where the head count divides it, else to the query
sequence (``_attn_axis``), and a cache sharded over batch, heads or
sequence takes each token's k and v on the rank that holds its slot.
"""

from __future__ import annotations

import collections
import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import flash_attn as fa
from repro_torch.models import sharding as shd
from repro_torch.models.layers import (norm_scale, normal_, rms_norm,
                                       rope_table, rotate)
from repro_torch.models.sharding import fsdp, hint
from repro_torch.spans import span

NEG_INF = -2.0 ** 30
ATTN_CHUNK = 512  # q-chunk size for memory-efficient attention
_DP = ("pod", "data")

# ``_sdpa`` calls by the path they took: "flash" (the kernel) or "einsum"
SDPA_PATHS: collections.Counter = collections.Counter()


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


def split_heads(t, heads: int):
    """(B, S, heads * hd) -> (B, S, heads, hd), hinted heads-on-"model";
    a DTensor whose head count does not divide the model axis is first
    gathered along its last dim (a head may not straddle shards)."""
    b, s_, width = t.shape
    mesh = shd.mesh_of(t)
    if mesh is not None and heads % mesh.shape.get("model", 1):
        t = hint(t, _DP, None, None)
    return hint(t.reshape(b, s_, heads, width // heads),
                _DP, None, "model", None)


def _attn_axis(h: int, q) -> str:
    """Shard the (B, H, S, T) attention intermediates on "model" via the
    HEAD axis when the head count divides the mesh (cheap), else via the
    QUERY SEQ axis (e.g. qwen1.5's 20 heads on a 16-way model axis); "none"
    for a plain q."""
    mesh = shd.mesh_of(q)
    if mesh is None or "model" not in mesh.axis_names:
        return "none"
    return "heads" if h % mesh.shape["model"] == 0 else "seq"


def _softmax_pv(logits: torch.Tensor, v: torch.Tensor,
                eq: str) -> torch.Tensor:
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum(eq, probs, v)


def _heads_local(q, k, v, kv_whole: bool):
    """The shard-local q, k, v of a body split like q (batch over the dp
    axes, heads or query sequence over "model"): k and v with their heads
    grouped under this rank's query heads (the whole k, v taken where
    their heads are not split with q's)."""
    split = [p.is_shard() for p in q.placements]
    ql = q.to_local()
    kl, vl = shd.local_grads(k, split), shd.local_grads(v, split)
    groups = q.shape[2] // k.shape[2]
    if kv_whole and ql.shape[2] != q.shape[2]:
        h0, hl = shd.shard_offset(q, 2), ql.shape[2]
        kl = _repeat_kv(kl, groups)[:, :, h0:h0 + hl]
        vl = _repeat_kv(vl, groups)[:, :, h0:h0 + hl]
    return ql, kl, vl


def _from_local_like(out, q):
    """A body's (B, S, H * hd) output as a DTensor laid out as q (B, S, H,
    hd): the heads' shard is a contiguous block of the last dim."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def _sdpa_sharded(q, k, v, scale: float, causal: bool, chunk: int):
    """``_sdpa`` on DTensors as a shard-local body: q laid out with the
    batch over the dp axes and the heads over "model" where they divide
    it, else the query sequence (``_attn_axis``); k and v with q's batch,
    and their heads over "model" where both head counts divide it, else
    whole.  Each rank attends its own (rows, heads) or (rows, queries):
    the same sums as the whole, no collective inside."""
    h, kvh = q.shape[2], k.shape[2]
    m = shd.mesh_of(q).shape.get("model", 1)
    ax = _attn_axis(h, q)
    whole = not (ax == "heads" and kvh % m == 0)
    q = hint(q, _DP, "model" if ax == "seq" else None,
             "model" if ax == "heads" else None, None)
    k = hint(k, _DP, None, None if whole else "model", None)
    v = hint(v, _DP, None, None if whole else "model", None)
    ql, kl, vl = _heads_local(q, k, v, whole)
    out = _sdpa(ql, kl, vl, scale, causal=causal, chunk=chunk,
                q0=shd.shard_offset(q, 1))
    return _from_local_like(out, q)


def _sdpa(q, k, v, scale: float, *, causal: bool = True,
          chunk: int = ATTN_CHUNK, q0: int = 0) -> torch.Tensor:
    """Causal attention.  q: (B, S, H, hd), k / v: (B, T, KV, hd) grouped;
    q's rows are the queries at positions q0, q0 + 1, ...  Returns (B, S,
    H * hd), a DTensor for DTensors (``_sdpa_sharded``)."""
    if shd.is_dtensor(q):
        return _sdpa_sharded(q, k, v, scale, causal, chunk)
    path = "flash" if fa.takes(q, k, v) else "einsum"
    SDPA_PATHS[path] += 1
    if path == "flash":
        return fa.flash_attn(q, k, v, scale, causal=causal, q0=q0)
    return _sdpa_einsum(q, k, v, scale, causal=causal, chunk=chunk, q0=q0)


def _sdpa_einsum(q, k, v, scale: float, *, causal: bool = True,
                 chunk: int = ATTN_CHUNK, q0: int = 0) -> torch.Tensor:
    """``_sdpa``'s einsum path: the reference's arithmetic, GQA by
    repeating k and v, queries in checkpointed chunks of `chunk`."""
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
        out = attend(q, torch.arange(q0, q0 + s, device=q.device))
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
            attend(q[:, c:c + chunk], torch.arange(q0 + c, q0 + c + chunk,
                                                   device=q.device))
            for c in range(0, s, chunk)], dim=1)
    return out.reshape(b, s, h * v.shape[-1])


def _banded(q, k, v, w: int) -> torch.Tensor:
    """The banded form of sliding-window attention over q (B, S, H, hd),
    k / v (B, S, KV, hd): (B, S, H * hd)."""
    b, s, h, hd = q.shape
    kvh = k.shape[2]
    nc = s // w

    def chunk(t):  # (B, S, H, hd) -> (B, nc, w, H, hd)
        return t.reshape(b, nc, w, t.shape[2], hd)

    def prev(t):   # the previous chunk, zeros for the first (masked)
        return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)

    qc, kc, vc = chunk(q), chunk(k), chunk(v)
    k2 = torch.cat([prev(kc), kc], dim=2)          # (B, nc, 2w, KV, hd)
    v2 = torch.cat([prev(vc), vc], dim=2)
    dev = q.device
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
    return out.reshape(b, s, h * hd)


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
        q, k, v = x @ fsdp(self.wq), x @ fsdp(self.wk), x @ fsdp(self.wv)
        if cfg.qkv_bias:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = split_heads(q, cfg.n_heads)
        k = split_heads(k, cfg.n_kv_heads)
        v = split_heads(v, cfg.n_kv_heads)
        if cfg.qk_norm:
            q = rms_norm(q, self.qnorm)
            k = rms_norm(k, self.knorm)
        return rotate(q, rope), rotate(k, rope), v

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        """Prefill / training attention over x (B, S, D): full causal, or
        banded for a local layer."""
        with span("repro_torch.attention"):
            if self.cfg.window is not None and x.shape[1] > self.cfg.window:
                return self._local(x, rope)
            q, k, v = self.qkv(x, rope)
            out = _sdpa(q, k, v, 1.0 / math.sqrt(self.cfg.head_dim))
            return out @ fsdp(self.wo)

    def _local(self, x: torch.Tensor, rope) -> torch.Tensor:
        """Sliding-window attention in the chunked two-block banded form:
        each chunk of w queries attends to itself and the previous chunk
        under the causal + window mask.  Exact for window <= w.  On
        DTensors a shard-local body over (rows, heads): the heads over
        "model" where both head counts divide it, else whole."""
        w = self.cfg.window
        if x.shape[1] % w:
            raise ValueError(f"seq {x.shape[1]} must be a multiple of "
                             f"window {w}")
        q, k, v = self.qkv(x, rope)
        if not shd.is_dtensor(q):
            return _banded(q, k, v, w) @ fsdp(self.wo)
        m = shd.mesh_of(q).shape.get("model", 1)
        ax = ("model" if self.cfg.n_heads % m == 0
              and self.cfg.n_kv_heads % m == 0 else None)
        q, k, v = (hint(t, _DP, None, ax, None) for t in (q, k, v))
        ql, kl, vl = _heads_local(q, k, v, False)
        return _from_local_like(_banded(ql, kl, vl, w), q) @ fsdp(self.wo)

    def decode(self, x: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               rope, where: "DecodeIndex") -> torch.Tensor:
        """One-token step.  x (B, 1, D); ck / cv (B, L, KV, hd), written in
        place at ``where.slot`` (DTensors under a mesh: by the rank that
        holds the slot); returns (B, 1, D)."""
        q, k, v = self.qkv(x, rope)
        shd.write_rows(ck, where.slot, k[:, 0])
        shd.write_rows(cv, where.slot, v[:, 0])
        if shd.is_dtensor(q):
            return _decode_sharded(q, ck, cv, where.valid) @ fsdp(self.wo)
        return _decode_local(q, ck, cv, where.valid) @ fsdp(self.wo)


def _decode_local(q, ck, cv, valid, reduce=None) -> torch.Tensor:
    """One query per row against a cache: q (B, 1, H, hd), ck / cv (B, L,
    KV, hd), valid (B, L) -> (B, 1, H * hd).  `reduce(t, op)` combines
    partial results across the shards of a sequence-split cache (the
    online softmax: MAX of the maxima, SUMs of the sums and of the partial
    values)."""
    b, _, h, hd = q.shape
    kvh = ck.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd)
    logits = torch.einsum("bskgd,btkd->bkgst", qg, ck).float()
    logits = logits * (1.0 / math.sqrt(hd))
    logits = torch.where(valid[:, None, None, None, :], logits, NEG_INF)
    if reduce is None:
        out = _softmax_pv(logits, cv, "bkgst,btkd->bskgd")
    else:
        top = reduce(logits.amax(dim=-1, keepdim=True), "max")
        unnorm = torch.exp(logits - top)
        total = reduce(unnorm.sum(dim=-1, keepdim=True), "sum")
        probs = (unnorm / torch.clamp(total, min=1e-30)).to(cv.dtype)
        out = reduce(torch.einsum("bkgst,btkd->bskgd", probs, cv), "sum")
    return out.reshape(b, 1, h * hd)


def _decode_sharded(q, ck, cv, valid):
    """``_decode_local`` on a DTensor cache, shard-local: q laid out as the
    cache (its rows, and its heads where the cache's KV heads are split);
    each rank attends over its (rows, heads, positions) and, where the
    cache's positions are split, the online softmax combines the shards
    on their groups."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    dm = ck.device_mesh
    cp = ck.placements
    qpl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
           else Replicate() for p in cp]
    ql = q.redistribute(dm, qpl).to_local()
    ckl, cvl = ck.to_local(), cv.to_local()
    r0, s0 = shd.shard_offset(ck, 0), shd.shard_offset(ck, 1)
    vl = shd.local(valid)[r0:r0 + ckl.shape[0], s0:s0 + ckl.shape[1]]
    seq = [dm.get_group(m) for m, p in enumerate(cp) if p.is_shard(1)]

    def reduce(t, op):
        for g in seq:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
        return t
    out = _decode_local(ql, ckl, cvl, vl, reduce if seq else None)
    opl = [Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2)
           else Replicate() for p in cp]
    return DTensor.from_local(out, dm, opl, run_check=False)


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


def decode_attention_seqsharded(attn: Attention, x: torch.Tensor,
                                cache: dict, pos, *, axis: str = "data",
                                mesh=None) -> tuple:
    """Distributed flash decode: the KV cache sharded along SEQUENCE on
    `axis` of `mesh` (default: the context mesh; none: one shard holds
    the whole cache).

    For long contexts, where a 0.5M-token cache cannot live on one card and
    batch 1 leaves no batch axis to shard.  ``cache`` holds this rank's
    slice {"k", "v"} (B, L / n, KV, hd) (``init_kv_cache(...,
    seq_shards=n)``), x (B, 1, D) the token on every rank, pos a scalar.
    Each rank attends over its slice with its own max and sum, then the
    softmax is renormalised across the shards: an all-reduce MAX of the
    maxima and SUMs of the sums and of the partial values on the axis's
    group.  The new token is written only by the owning shard.  Returns
    (out (B, 1, D), cache)."""
    import torch.distributed._functional_collectives as funcol
    mesh = shd.get_context_mesh() if mesh is None else mesh
    group = mesh.group(axis) if mesh is not None else None

    def reduce(t, op):
        if group is None:
            return t
        return funcol.wait_tensor(funcol.all_reduce(t, op, group))

    cfg = attn.cfg
    b = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    pos = torch.as_tensor(pos, device=ck.device).reshape(())
    positions = torch.full((b, 1), 0, dtype=torch.int64,
                           device=ck.device) + pos
    q, k, v = (shd.full(t) for t in attn.qkv(
        x, rope_table(positions, cfg.head_dim, cfg.rope_theta)))
    length = ck.shape[1]                       # local slice length
    start = (mesh.coord(axis) if mesh is not None else 0) * length
    slot = pos - start
    owns = (slot >= 0) & (slot < length)
    safe = torch.clamp(slot, 0, length - 1)
    ck[:, safe] = torch.where(owns, k[:, 0], ck[:, safe])
    cv[:, safe] = torch.where(owns, v[:, 0], cv[:, safe])
    valid = (torch.arange(length, device=ck.device) + start <= pos).expand(
        b, length)
    # two-phase online softmax across shards
    out = _decode_local(q, ck, cv, valid, reduce)
    return shd.like(out, attn.wo) @ fsdp(attn.wo), cache


def init_kv_cache(cfg: AttnConfig, batch: int, max_len: int, dtype,
                  device, *, layers: int = 1, seq_shards: int = 1) -> dict:
    """Zero k and v caches (layers, B, L, KV, hd), one per stacked layer: a
    full cache (L = max_len, or this rank's max_len / `seq_shards` slice
    for the sequence-sharded decode) for global layers, a ring of the
    window for local ones."""
    length = (min(max_len, cfg.window) if cfg.window
              else max_len // seq_shards)
    shape = (layers, batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
