"""Mamba-1 (S6 selective state space) mixer, for Jamba's 7-of-8 layers
(port of ``repro.models.mamba``).

A block: in_proj (D -> 2 * d_inner: x, z) -> causal depthwise conv1d +
silu -> selective scan h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = C_t
. h_t + D_skip x_t -> silu(z) gate -> out_proj.

The scan walks the sequence in chunks of ``chunk`` steps, as the
reference does (its ``t % chunk == 0`` condition is a ``ValueError``
here), and inside a chunk step by step: the reference runs an
associative scan there, which torch does not have, and the loop computes
the same recurrence with its float32 products in another order.  The
exp(+-cumsum) closed form is not used: exp(-cumsum(dt A)) overflows
float32 at Jamba's widths.

Decode carries (conv state (B, d_conv - 1, di) in the model's dtype,
ssm state (B, di, d_state) float32), updated in place.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import sharding as shd
from repro_torch.models.sharding import fsdp
from repro_torch.models.layers import normal_


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0          # 0 = ceil(d_model / 16)
    chunk: int = 64

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or int(math.ceil(self.d_model / 16))


class Mamba(nn.Module):
    """Parameters in the reference's layout: in_proj (D, 2di), conv_w
    (d_conv, di), conv_b (di,), x_proj (di, rank + 2 ds), dt_proj (rank,
    di), out_proj (di, D) in the model's dtype; dt_bias (di,), a_log (di,
    ds) and d_skip (di, 1) float32."""

    def __init__(self, cfg: MambaConfig, *, device, dtype):
        super().__init__()
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        d, di, ds, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
        self.in_proj = nn.Parameter(torch.empty(d, 2 * di, **kw))
        self.conv_w = nn.Parameter(torch.empty(cfg.d_conv, di, **kw))
        self.conv_b = nn.Parameter(torch.zeros(di, **kw))
        self.x_proj = nn.Parameter(torch.empty(di, r + 2 * ds, **kw))
        self.dt_proj = nn.Parameter(torch.empty(r, di, **kw))
        self.dt_bias = nn.Parameter(torch.empty(di, **f32))
        self.a_log = nn.Parameter(torch.empty(di, ds, **f32))
        self.d_skip = nn.Parameter(torch.ones(di, 1, **f32))
        self.out_proj = nn.Parameter(torch.empty(di, d, **kw))

    @torch.no_grad()
    def init_weights(self, gen: torch.Generator) -> None:
        """The reference's scales and constants (``mamba.py:44-60``): dt
        bias softplus^-1(0.01), A the S4D-real 1..d_state."""
        cfg = self.cfg
        di = cfg.d_inner
        normal_(self.in_proj, gen, 1.0 / math.sqrt(cfg.d_model))
        normal_(self.conv_w, gen, 1.0 / math.sqrt(cfg.d_conv))
        normal_(self.x_proj, gen, 1.0 / math.sqrt(di))
        normal_(self.dt_proj, gen, 1.0 / math.sqrt(cfg.rank))
        normal_(self.out_proj, gen, 1.0 / math.sqrt(di))
        self.conv_b.zero_()
        self.dt_bias.copy_(torch.log(torch.expm1(torch.full_like(
            self.dt_bias, 1e-2))))
        a = torch.arange(1, cfg.d_state + 1, dtype=torch.float32,
                         device=self.a_log.device)
        self.a_log.copy_(torch.log(a).expand(di, -1))
        self.d_skip.fill_(1.0)

    def _conv(self, x: torch.Tensor, state=None):
        """Causal depthwise conv + silu (``mamba.py:131-141``).  x (B, T,
        di); state (B, d_conv - 1, di) or None (zeros).  Returns (out, the
        last d_conv - 1 inputs)."""
        dc = self.cfg.d_conv
        w = self.conv_w.to(x.dtype)
        pad = (x.new_zeros((x.shape[0], dc - 1, x.shape[2]))
               if state is None else state)
        xp = torch.cat([pad, x], dim=1)
        t = x.shape[1]
        out = sum(xp[:, i:i + t] * w[i] for i in range(dc))
        new_state = xp[:, -(dc - 1):] if dc > 1 else pad
        return F.silu(out + self.conv_b.to(x.dtype)), new_state

    def _ssm_inputs(self, xc: torch.Tensor):
        """dt (B, T, di), B and C (B, T, ds), float32 (``mamba.py:63-70``)."""
        r, ds = self.cfg.rank, self.cfg.d_state
        dt_r, b, c = (xc @ fsdp(self.x_proj)).split([r, ds, ds], dim=-1)
        dt = F.softplus((dt_r @ fsdp(self.dt_proj)).float() + self.dt_bias)
        return dt, b.float(), c.float()

    def _scan(self, dt, xc, b_mat, c_mat, h):
        """The selective scan with its output projection fused
        (``mamba.py:73-128``): dt (B, T, di) float32, xc (B, T, di), B / C
        (B, T, ds) float32, h (B, di, ds) float32.  Returns (y (B, T, di)
        float32, the last state).  On DTensors a shard-local body over the
        batch rows (``sharding.rows_local``)."""
        return shd.rows_local(self._scan_local, (dt, xc, b_mat, c_mat, h),
                              (self.a_log,))

    def _scan_local(self, dt, xc, b_mat, c_mat, h, a_log):
        t = dt.shape[1]
        q = min(self.cfg.chunk, t)
        if t % q:
            raise ValueError(f"seq {t} must be a multiple of the scan chunk "
                             f"{q}")
        a = -torch.exp(a_log)                                 # (di, ds)
        ys = []
        for c0 in range(0, t, q):
            dt_c, b_c, c_c = dt[:, c0:c0 + q], b_mat[:, c0:c0 + q], \
                c_mat[:, c0:c0 + q]
            a_coef = torch.exp(dt_c[..., None] * a)           # (B, q, di, ds)
            b_in = (dt_c * xc[:, c0:c0 + q].float())[..., None] \
                * b_c[:, :, None, :]
            for i in range(q):
                h = a_coef[:, i] * h + b_in[:, i]
                ys.append(torch.einsum("bds,bs->bd", h, c_c[:, i]))
        return torch.stack(ys, dim=1), h

    def forward(self, x: torch.Tensor, rope=None) -> torch.Tensor:
        """Training / prefill, x (B, T, D) -> (B, T, D)
        (``mamba.py:144-157``)."""
        cfg = self.cfg
        xi, z = (x @ fsdp(self.in_proj)).chunk(2, dim=-1)
        xc, _ = self._conv(xi)
        dt, b_mat, c_mat = self._ssm_inputs(xc)
        h0 = shd.like(torch.zeros((x.shape[0], cfg.d_inner, cfg.d_state),
                                  dtype=torch.float32, device=x.device), x)
        y, _ = self._scan(dt, xc, b_mat, c_mat, h0)
        y = y + xc.float() * self.d_skip[:, 0]
        return (y.to(x.dtype) * F.silu(z)) @ fsdp(self.out_proj)

    def decode(self, x: torch.Tensor, conv: torch.Tensor,
               ssm: torch.Tensor) -> torch.Tensor:
        """One-token step (``mamba.py:167-185``).  x (B, 1, D); conv
        (B, d_conv - 1, di) and ssm (B, di, ds) updated in place."""
        xi, z = (x @ fsdp(self.in_proj)).chunk(2, dim=-1)
        xc, conv_state = self._conv(xi, conv)
        dt, b_mat, c_mat = self._ssm_inputs(xc)
        a = -torch.exp(self.a_log)
        a_coef = torch.exp(dt[:, 0, :, None] * a)             # (B, di, ds)
        b_in = (dt[:, 0] * xc[:, 0].float())[..., None] * b_mat[:, 0, None, :]
        h = a_coef * ssm + b_in
        y = torch.einsum("bds,bs->bd", h, c_mat[:, 0])
        y = y + xc[:, 0].float() * self.d_skip[:, 0]
        y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None]
        shd.assign(conv, conv_state)
        shd.assign(ssm, h)
        return y @ fsdp(self.out_proj)


def init_mamba_state(cfg: MambaConfig, batch: int, dtype, device, *,
                     layers: int = 1) -> dict:
    """Zero states: conv (layers, B, d_conv - 1, di) in the model's dtype,
    ssm (layers, B, di, ds) float32."""
    return {"conv": torch.zeros((layers, batch, cfg.d_conv - 1,
                                 cfg.d_inner), dtype=dtype, device=device),
            "ssm": torch.zeros((layers, batch, cfg.d_inner, cfg.d_state),
                               dtype=torch.float32, device=device)}
