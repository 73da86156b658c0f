"""xLSTM mixers, mLSTM and sLSTM, for the xlstm-125m architecture (port
of ``repro.models.xlstm``).

mLSTM: a matrix memory with exponential gating,
  C_t = f_t C_{t-1} + i_t v_t k_t^T,  n_t = f_t n_{t-1} + i_t k_t,
  y_t = C_t q_t / max(|n_t^T q_t|, exp(-m_t)),
computed chunkwise: the parallel, attention-like form inside a chunk
(decay matrix with a -inf upper triangle, stabilised by a running max m)
and the recurrent (C, n, m) state across chunks.

sLSTM: a scalar memory with exponential gating and recurrent gate weights,
sequential over time, followed by a GLU ffn (gelu, tanh approximation, as
``jax.nn.gelu``'s default).

Each keeps the reference's casts (the chunk's products in the
activations' dtype, gates and state in float32).  Decode carries O(1)
state per token, updated in place: mLSTM {"c", "n", "m"}, sLSTM {"c",
"n", "m", "h"}.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as shd
from repro_torch.models.attention import split_heads
from repro_torch.models.layers import normal_
from repro_torch.models.sharding import fsdp


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    d_model: int
    n_heads: int = 4
    proj_factor: float = 2.0     # mLSTM up-projection
    chunk: int = 128

    @property
    def d_inner(self) -> int:
        return int(self.proj_factor * self.d_model)

    @property
    def head_dim(self) -> int:
        return self.d_inner // self.n_heads


# ----------------------------------------------------------------- mLSTM ---

def _mlstm_chunks(qc: int, q, k, v, log_i, log_f):
    """The mLSTM over the whole sequence, chunk by chunk from a zero state:
    (B, H, T, hd)."""
    b, h, t, hd = q.shape
    f32 = dict(dtype=torch.float32, device=q.device)
    state = (torch.zeros((b, h, hd, hd), **f32),
             torch.zeros((b, h, hd), **f32), torch.zeros((b, h), **f32))
    ys = []
    for c0 in range(0, t, qc):
        sl = slice(c0, c0 + qc)
        y, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl], v[:, :, sl],
                                log_i[..., sl], log_f[..., sl], state)
        ys.append(y)
    return torch.cat(ys, dim=2)


def _mlstm_step(head_dim: int, q, k, v, log_i, log_f, c, n, m):
    """One recurrent mLSTM step (``xlstm.py:168-190``): q / k / v (B, H,
    1, hd), the gate logs (B, H, 1), the state c (B, H, hd, hd), n (B, H,
    hd), m (B, H) -> (y (B, H, hd), the new c, n, m)."""
    q, k, v = q[:, :, 0], k[:, :, 0], v[:, :, 0]          # (B, H, hd)
    li, lf = log_i[:, :, 0], log_f[:, :, 0]               # (B, H)
    m_new = torch.maximum(lf + m, li)
    decay = torch.exp(lf + m - m_new)
    inp_w = torch.exp(li - m_new)
    kf, vf = k.float(), v.float()
    c_new = decay[..., None, None] * c + inp_w[..., None, None] \
        * kf[..., :, None] * vf[..., None, :]
    n_new = decay[..., None] * n + inp_w[..., None] * kf
    scale = 1.0 / math.sqrt(head_dim)
    qf = q.float()
    num = torch.einsum("bhd,bhde->bhe", qf, c_new) * scale
    den = torch.einsum("bhd,bhd->bh", qf, n_new) * scale
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return y, c_new, n_new, m_new


def _mlstm_chunk(q, k, v, log_i, log_f, state):
    """One chunk of the parallel mLSTM (``xlstm.py:62-110``).  q / k / v
    (B, H, Q, hd); log_i / log_f (B, H, Q) float32; state (C, n, m)."""
    c_prev, n_prev, m_prev = state
    qlen, hd = q.shape[2], q.shape[3]
    lf_cum = torch.cumsum(log_f, dim=-1)                       # (B,H,Q)
    d_mat = (lf_cum[..., :, None] - lf_cum[..., None, :]
             + log_i[..., None, :])                            # (B,H,Q,Q)
    tri = torch.ones((qlen, qlen), dtype=torch.bool,
                     device=q.device).tril()
    d_mat = torch.where(tri, d_mat, -math.inf)
    m_inter = lf_cum + m_prev[..., None]
    m_intra = torch.amax(d_mat, dim=-1)
    m_t = torch.maximum(m_inter, m_intra)
    scale = 1.0 / math.sqrt(hd)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    w = scores * torch.exp(d_mat - m_t[..., None])
    inter_w = torch.exp(m_inter - m_t)
    num = (torch.einsum("bhqk,bhkd->bhqd", w.to(v.dtype), v)
           + inter_w[..., None].to(v.dtype)
           * torch.einsum("bhqd,bhde->bhqe", q, c_prev.to(q.dtype)) * scale)
    den = (w.sum(-1) + inter_w
           * torch.einsum("bhqd,bhd->bhq", q, n_prev.to(q.dtype)) * scale)
    y = num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None].to(v.dtype)
    lf_total = lf_cum[..., -1]                                 # (B,H)
    m_new = torch.maximum(lf_total + m_prev, torch.amax(
        lf_total[..., None] - lf_cum + log_i, dim=-1))
    decay_old = torch.exp(lf_total + m_prev - m_new)
    tok_w = torch.exp(lf_total[..., None] - lf_cum + log_i - m_new[..., None])
    kf, vf = k.float(), v.float()
    c_new = (decay_old[..., None, None] * c_prev
             + torch.einsum("bhq,bhqd,bhqe->bhde", tok_w, kf, vf))
    n_new = (decay_old[..., None] * n_prev
             + torch.einsum("bhq,bhqd->bhd", tok_w, kf))
    return y, (c_new, n_new, m_new)


class MLSTM(nn.Module):
    """Parameters in the reference's layout: up_proj (D, 2di), wq / wk /
    wv (di, di), wi / wf (di, H), down_proj (di, D), skip_w (di,)
    float32."""

    def __init__(self, cfg: XLSTMConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d, di, h = cfg.d_model, cfg.d_inner, cfg.n_heads
        self.up_proj = nn.Parameter(torch.empty(d, 2 * di, **kw))
        self.wq = nn.Parameter(torch.empty(di, di, **kw))
        self.wk = nn.Parameter(torch.empty(di, di, **kw))
        self.wv = nn.Parameter(torch.empty(di, di, **kw))
        self.wi = nn.Parameter(torch.empty(di, h, **kw))
        self.wf = nn.Parameter(torch.empty(di, h, **kw))
        self.skip_w = nn.Parameter(torch.ones(di, device=device,
                                              dtype=torch.float32))
        self.down_proj = nn.Parameter(torch.empty(di, d, **kw))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales (``xlstm.py:47-59``)."""
        si = 1.0 / math.sqrt(self.cfg.d_inner)
        normal_(self.up_proj, gen, 1.0 / math.sqrt(self.cfg.d_model))
        for w in (self.wq, self.wk, self.wv, self.wi, self.wf,
                  self.down_proj):
            normal_(w, gen, si)
        self.skip_w.fill_(1.0)

    def _qkvif(self, xu: torch.Tensor):
        """q / k / v (B, H, T, hd) and the float32 gate logs (B, H, T)
        (``xlstm.py:113-122``)."""
        def heads(m):
            return split_heads(xu @ m, self.cfg.n_heads).transpose(1, 2)
        log_i = (xu @ fsdp(self.wi)).float().transpose(1, 2)
        log_f = shd.elementwise(F.logsigmoid,
                                (xu @ fsdp(self.wf)).float()).transpose(1, 2)
        return (heads(fsdp(self.wq)), heads(fsdp(self.wk)),
                heads(fsdp(self.wv)), log_i, log_f)

    def _out(self, y: torch.Tensor, xu, z, dtype) -> torch.Tensor:
        y = y.to(dtype) + xu * self.skip_w.to(xu.dtype)
        return (y * F.silu(z)) @ fsdp(self.down_proj)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        """x (B, T, D) -> (B, T, D), chunk by chunk (``xlstm.py:125-158``)."""
        cfg = self.cfg
        b, t, _ = x.shape
        xu, z = (x @ fsdp(self.up_proj)).chunk(2, dim=-1)
        q, k, v, log_i, log_f = self._qkvif(xu)
        qc = min(cfg.chunk, t)
        if t % qc:
            raise ValueError(f"seq {t} must be a multiple of the mLSTM chunk "
                             f"{qc}")
        y = shd.rows_local(functools.partial(_mlstm_chunks, qc),
                           (q, k, v, log_i, log_f))
        y = y.transpose(1, 2).reshape(b, t, cfg.d_inner)
        return self._out(y, xu, z, x.dtype)

    def decode(self, x: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor) -> torch.Tensor:
        """One-token step (``xlstm.py:168-190``).  x (B, 1, D); c (B, H,
        hd, hd), n (B, H, hd), m (B, H) updated in place."""
        xu, z = (x @ fsdp(self.up_proj)).chunk(2, dim=-1)
        q, k, v, log_i, log_f = self._qkvif(xu)
        y, c_new, n_new, m_new = shd.rows_local(
            functools.partial(_mlstm_step, self.cfg.head_dim),
            (q, k, v, log_i, log_f, c, n, m))
        shd.assign(c, c_new)
        shd.assign(n, n_new)
        shd.assign(m, m_new)
        return self._out(y.reshape(x.shape[0], 1, self.cfg.d_inner), xu, z,
                         x.dtype)


def init_mlstm_state(cfg: XLSTMConfig, batch: int, device, *,
                     layers: int = 1) -> dict:
    """Zero float32 states c (layers, B, H, hd, hd), n (layers, B, H, hd),
    m (layers, B, H)."""
    h, hd = cfg.n_heads, cfg.head_dim
    kw = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((layers, batch, h, hd, hd), **kw),
            "n": torch.zeros((layers, batch, h, hd), **kw),
            "m": torch.zeros((layers, batch, h), **kw)}


# ----------------------------------------------------------------- sLSTM ---

_GATES = ("z", "i", "f", "o")


class SLSTM(nn.Module):
    """Parameters in the reference's layout: w{z,i,f,o} and r{z,i,f,o}
    (D, D), b{z,i,f,o} (D,) float32, up_proj (D, 2D), down_proj (D, D)."""

    def __init__(self, cfg: XLSTMConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        d = cfg.d_model
        for g in _GATES:
            setattr(self, f"w{g}", nn.Parameter(torch.empty(d, d, **kw)))
            setattr(self, f"r{g}", nn.Parameter(torch.empty(d, d, **kw)))
            setattr(self, f"b{g}", nn.Parameter(torch.zeros(
                d, device=device, dtype=torch.float32)))
        self.up_proj = nn.Parameter(torch.empty(d, 2 * d, **kw))
        self.down_proj = nn.Parameter(torch.empty(d, d, **kw))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales (``xlstm.py:195-206``); biases zero."""
        s = 1.0 / math.sqrt(self.cfg.d_model)
        for g in _GATES:
            normal_(getattr(self, f"w{g}"), gen, s)
            normal_(getattr(self, f"r{g}"), gen, s)
            getattr(self, f"b{g}").zero_()
        normal_(self.up_proj, gen, s)
        normal_(self.down_proj, gen, s)

    def _gates(self) -> tuple:
        """w, r and b of each gate, in _GATES order, 12 tensors."""
        return tuple(getattr(self, f"{kind}{g}") for g in _GATES
                     for kind in "wrb")

    def _step(self, carry, x_t, gates=None):
        """x_t (B, D); carry (c, n, m, h_prev), each (B, D) float32
        (``xlstm.py:209-226``); `gates` the weights (default the
        module's)."""
        gates = self._gates() if gates is None else gates
        c, n, m, h_prev = carry
        hp = h_prev.to(x_t.dtype)

        def gate(i):
            w, r, b = gates[3 * i:3 * i + 3]
            return ((x_t @ fsdp(w) + hp @ fsdp(r)).float() + b)
        z = torch.tanh(gate(0))
        i_log = gate(1)
        f_log = shd.elementwise(F.logsigmoid, gate(2))
        o = torch.sigmoid(gate(3))
        m_new = torch.maximum(f_log + m, i_log)
        i_g = torch.exp(i_log - m_new)
        f_g = torch.exp(f_log + m - m_new)
        c_new = f_g * c + i_g * z
        n_new = f_g * n + i_g
        # maximum, not clamp: n_new is exactly 1 at a first step whose
        # input gate wins, and the tie splits the gradient as jax's does
        h_new = o * c_new / torch.maximum(n_new, torch.ones_like(n_new))
        return c_new, n_new, m_new, h_new

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        a, b = (h @ fsdp(self.up_proj)).chunk(2, dim=-1)
        return (F.gelu(a, approximate="tanh") * b) @ fsdp(self.down_proj)

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        """x (B, T, D) -> (B, T, D), sequential over T
        (``xlstm.py:229-240``)."""
        h = shd.rows_local(self._recur, (x,), self._gates())
        return self._ffn(h.to(x.dtype))

    def _recur(self, x, *gates):
        """The recurrence over x (B, T, D) from a zero state: the hidden
        states (B, T, D) float32."""
        b, t, d = x.shape
        zero = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        carry = (zero, zero, zero, zero)
        hs = []
        for i in range(t):
            carry = self._step(carry, x[:, i], gates)
            hs.append(carry[3])
        return torch.stack(hs, dim=1)

    def decode(self, x: torch.Tensor, c: torch.Tensor, n: torch.Tensor,
               m: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """One-token step (``xlstm.py:249-256``); the (B, D) states are
        updated in place."""
        new = self._step((c, n, m, h), x[:, 0])
        for dst, src in zip((c, n, m, h), new):
            shd.assign(dst, src)
        return self._ffn(new[3].to(x.dtype)[:, None])


def init_slstm_state(cfg: XLSTMConfig, batch: int, device, *,
                     layers: int = 1) -> dict:
    """Zero float32 states c, n, m, h, each (layers, B, D)."""
    return {k: torch.zeros((layers, batch, cfg.d_model), dtype=torch.float32,
                           device=device) for k in ("c", "n", "m", "h")}
