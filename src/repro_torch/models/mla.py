"""Multi-head Latent Attention, DeepSeek-V2 / V3 (port of
``repro.models.mla``).

Queries and keys / values come through low-rank compressions:

  q:  x -> (q_lora) -> norm -> per head [nope | rope]
  kv: x -> (kv_lora | k_rope);  kv_lora -> norm -> per head [k_nope | v];
      k_rope is shared by the heads.

Training and prefill expand k and v per head and run the port's chunked
causal attention (``attention._sdpa``) with the rope part concatenated
onto the nope part.  Decode caches only the compressed (c_kv, k_rope)
pair and runs in the latent space with the key and value halves of
``wkv_b`` absorbed into the query and the output ("absorbed matrices").
The rotary table is one of ``rope_dim`` channels (``layers.rope_table``),
not of the model's head width.  The cache is written in place.

With YaRN (``MLAConfig.yarn``, DeepSeek-V3's ``rope_scaling``) the rotary
table the model passes in is YaRN's, and the softmax scale of ``forward``
and the absorbed ``decode`` alike is (nope + rope)^-0.5 times
``Yarn.softmax_mscale``: 192^-0.5 (0.1 ln 40 + 1)^2 = 0.135234 for
DeepSeek-V3.

Spans: ``forward`` runs in ``repro_torch.attention``, and its latent
stage (the q and kv compressions and their norms, the rotation, the
``wkv_b`` expansion and the concatenation) in ``repro_torch.mla.latent``
inside it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from repro_torch.models import sharding as shd
from repro_torch.models.sharding import fsdp
from repro_torch.models.attention import NEG_INF, DecodeIndex, _sdpa
from repro_torch.models.layers import (Yarn, norm_scale, normal_, rms_norm,
                                       rotate)
from repro_torch.spans import span


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    q_lora: int = 1536
    kv_lora: int = 512
    nope_dim: int = 128
    rope_dim: int = 64
    v_dim: int = 128
    rope_theta: float = 10_000.0
    yarn: Optional[Yarn] = None


class MLA(nn.Module):
    """Parameters in the reference's layout: wq_a (D, q_lora), wq_b
    (q_lora, H*(nope+rope)), wkv_a (D, kv_lora+rope), wkv_b (kv_lora,
    H*(nope+v)), wo (H*v, D), and the float32 norms q_a_norm (q_lora,),
    kv_a_norm (kv_lora,)."""

    def __init__(self, cfg: MLAConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        h, d = cfg.n_heads, cfg.d_model
        self.wq_a = nn.Parameter(torch.empty(d, cfg.q_lora, **kw))
        self.wq_b = nn.Parameter(torch.empty(
            cfg.q_lora, h * (cfg.nope_dim + cfg.rope_dim), **kw))
        self.wkv_a = nn.Parameter(torch.empty(d, cfg.kv_lora + cfg.rope_dim,
                                              **kw))
        self.wkv_b = nn.Parameter(torch.empty(
            cfg.kv_lora, h * (cfg.nope_dim + cfg.v_dim), **kw))
        self.wo = nn.Parameter(torch.empty(h * cfg.v_dim, d, **kw))
        self.q_a_norm = norm_scale(cfg.q_lora, device)
        self.kv_a_norm = norm_scale(cfg.kv_lora, device)

    @property
    def rope_dim(self) -> int:
        return self.cfg.rope_dim

    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales (``mla.py:46-60``)."""
        cfg = self.cfg
        s = 1.0 / math.sqrt(cfg.d_model)
        normal_(self.wq_a, gen, s)
        normal_(self.wq_b, gen, 1.0 / math.sqrt(cfg.q_lora))
        normal_(self.wkv_a, gen, s)
        normal_(self.wkv_b, gen, 1.0 / math.sqrt(cfg.kv_lora))
        normal_(self.wo, gen, 1.0 / math.sqrt(cfg.n_heads * cfg.v_dim))

    def _project(self, x: torch.Tensor, rope):
        """Per-head q_nope, q_rope (B, S, H, .) and the compressed c_kv
        (B, S, kv_lora), k_rope (B, S, rope) (``mla.py:63-77``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        cq = rms_norm(x @ fsdp(self.wq_a), self.q_a_norm)
        q = (cq @ fsdp(self.wq_b)).reshape(b, s, cfg.n_heads,
                                     cfg.nope_dim + cfg.rope_dim)
        q_nope, q_rope = q.split([cfg.nope_dim, cfg.rope_dim], dim=-1)
        kv = x @ fsdp(self.wkv_a)
        c_kv, k_rope = kv.split([cfg.kv_lora, cfg.rope_dim], dim=-1)
        c_kv = rms_norm(c_kv, self.kv_a_norm)
        k_rope = rotate(k_rope[:, :, None, :], rope)[:, :, 0, :]
        return q_nope, rotate(q_rope, rope), c_kv, k_rope

    def _wkv_b(self):
        """wkv_b per head: its key half (kv_lora, H, nope) and value half
        (kv_lora, H, v)."""
        cfg = self.cfg
        kvb = fsdp(self.wkv_b).reshape(cfg.kv_lora, cfg.n_heads,
                                 cfg.nope_dim + cfg.v_dim)
        return kvb[..., :cfg.nope_dim], kvb[..., cfg.nope_dim:]

    def _scale(self) -> float:
        scale = 1.0 / math.sqrt(self.cfg.nope_dim + self.cfg.rope_dim)
        if self.cfg.yarn is None:
            return scale
        return scale * self.cfg.yarn.softmax_mscale

    def forward(self, x: torch.Tensor, rope) -> torch.Tensor:
        """Training / prefill over x (B, S, D) (``mla.py:80-99``)."""
        cfg = self.cfg
        b, s, _ = x.shape
        with span("repro_torch.attention"):
            with span("repro_torch.mla.latent"):
                q_nope, q_rope, c_kv, k_rope = self._project(x, rope)
                wk, wv = self._wkv_b()
                k_nope = torch.einsum("bsc,chd->bshd", c_kv, wk)
                v = torch.einsum("bsc,chd->bshd", c_kv, wv)
                q_cat = torch.cat([q_nope, q_rope], dim=-1)
                k_cat = torch.cat([k_nope, k_rope[:, :, None, :].expand(
                    b, s, cfg.n_heads, cfg.rope_dim)], dim=-1)
            return _sdpa(q_cat, k_cat, v, self._scale()) @ fsdp(self.wo)

    def decode(self, x: torch.Tensor, c_kv: torch.Tensor,
               k_rope: torch.Tensor, rope,
               where: DecodeIndex) -> torch.Tensor:
        """One-token absorbed step (``mla.py:109-139``).  x (B, 1, D);
        c_kv (B, L, kv_lora) and k_rope (B, L, rope), written in place at
        ``where.slot``; returns (B, 1, D)."""
        cfg = self.cfg
        b = x.shape[0]
        q_nope, q_rope, c_new, k_new = self._project(x, rope)
        shd.write_rows(c_kv, where.slot, c_new[:, 0])
        shd.write_rows(k_rope, where.slot, k_new[:, 0])
        wk, wv = self._wkv_b()
        q_c = torch.einsum("bshd,chd->bshc", q_nope, wk)
        logits = (torch.einsum("bshc,btc->bhst", q_c, c_kv)
                  + torch.einsum("bshd,btd->bhst", q_rope, k_rope)
                  ).float() * self._scale()
        logits = torch.where(shd.like(where.valid[:, None, None, :], logits),
                             logits, NEG_INF)
        probs = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bhst,btc->bshc", probs.to(c_kv.dtype), c_kv)
        out = torch.einsum("bshc,chd->bshd", ctx, wv)
        return out.reshape(b, 1, cfg.n_heads * cfg.v_dim) @ fsdp(self.wo)


def init_mla_cache(cfg: MLAConfig, batch: int, max_len: int, dtype, device,
                   *, layers: int = 1) -> dict:
    """Zero compressed caches, c_kv (layers, B, L, kv_lora) and k_rope
    (layers, B, L, rope), in the model's dtype."""
    def zeros(width):
        return torch.zeros((layers, batch, max_len, width), dtype=dtype,
                           device=device)
    return {"c_kv": zeros(cfg.kv_lora), "k_rope": zeros(cfg.rope_dim)}
