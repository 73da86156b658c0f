"""AdamW with float32 or int8 moments (port of ``repro.optim.adamw``).

moment_dtype:
  "float32" -- standard.
  "int8"    -- 8-bit blockwise-quantized moments: int8 codes in the
               parameter's shape and one float32 absmax scale per block of
               256 along the last axis, dequantized to float32 for the
               update and quantized again after it (a quarter of the
               float32 state).

Params may be bfloat16; the update computes in float32 and casts back.
Global-norm clipping and decoupled weight decay are included.

Layout.  The reference keeps one leaf per pattern position, stacked over
the layers; the port keeps one tensor per layer, keyed by parameter name
(``dict(model.named_parameters())``).  Whether a moment is int8 is decided
on the reference's stacked leaf (``layers`` x the parameter's size), so a
per-layer parameter below 65,536 elements whose stack reaches it is int8
in both packages.  The blocks run along the last axis, so per-layer codes
and scales stack into the reference's exactly
(``models.convert.opt_state_to_reference``).

Arithmetic.  The reference's update runs compiled, and XLA rewrites it:
each moment update ``b * m + (1 - b) * x`` becomes one fused multiply-add
``fma(b, m, (1 - b) * x)``, ``mhat / (sqrt(nhat) + eps)`` becomes
``mu / (b1c * (sqrt(nu / b2c) + eps))``, the weight decay and the step
are two more fused multiply-adds, and ``/ 127.0`` is a product by
float32(1/127).  The port computes the same expressions, each fused
multiply-add as a float64 product and sum rounded once to float32.  The
float32 moments and the int8 codes then equal the reference's bit for bit
for the same gradients and clip scale.  What is not matched, and counted
by ``tests/test_torch_optim.py``: XLA's float32 square root on the CPU is
not correctly rounded (torch's is), so a parameter can differ by an ulp
of its step; the fusion that takes the int8 absmax recomputes the moment
with the other product contracted, so a scale can differ by an ulp, and
after it a code at a rounding boundary by one step; and the clip scale
follows from a global norm summed in another order.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"      # "float32" | "int8"
    block: int = 256


INT8_MIN_ELEMENTS = 1 << 16
_RECIP_127 = float(np.float32(1.0 / 127.0))


def int8_eligible(shape, block: int, layers: int = 1) -> bool:
    """Whether a parameter's moments are int8: its last axis divides into
    blocks and its reference leaf (`layers` stacked copies) holds at least
    65,536 elements.  Smaller leaves (norms, biases) stay float32."""
    return (len(shape) >= 1 and shape[-1] % block == 0
            and layers * math.prod(shape) >= INT8_MIN_ELEMENTS)


def _f32(x: float) -> float:
    """A Python number as the float32 the reference's arithmetic sees."""
    return float(np.float32(x))


def _fma(a, b, c) -> torch.Tensor:
    """float32(a * b + c) rounded once: the float64 product of two float32
    values is exact, and its sum with a float32 rounds to float32 as one
    fused multiply-add does (a double rounding differs only in ties of the
    float64 sum, about one case in 2^29)."""
    def wide(x):
        return x.double() if isinstance(x, torch.Tensor) else x
    return (wide(a) * wide(b) + wide(c)).float()


def encode_moment(x: torch.Tensor, cfg: AdamWConfig, int8: bool):
    """A float32 moment as stored: itself, or (`int8`) ``{"codes",
    "scale"}`` with codes in x's shape and scales (..., last // block)."""
    if cfg.moment_dtype == "float32" or not int8:
        return x.float()
    nb = x.shape[-1] // cfg.block
    blocks = x.reshape(*x.shape[:-1], nb, cfg.block)
    scale = blocks.abs().amax(dim=-1) * _RECIP_127
    scale = torch.where(scale <= 0, torch.ones_like(scale), scale)
    codes = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return {"codes": codes.reshape(x.shape).to(torch.int8), "scale": scale}


def decode_moment(m, shape) -> torch.Tensor:
    """The float32 moment of a stored one."""
    if not isinstance(m, dict):
        return m
    scale = m["scale"]
    blocks = m["codes"].float().reshape(*shape[:-1], scale.shape[-1], -1)
    return (blocks * scale[..., None]).reshape(shape)


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
               layers: Optional[Mapping[str, int]] = None) -> dict:
    """Zero moments for `params` (name -> tensor), on each parameter's
    device: ``{"step": 0, "mu": {name: moment}, "nu": {...}}``.  `layers`
    gives, by name, how many layers the reference stacks the parameter
    with (``models.convert.stacked_layers``; default 1)."""
    layers = layers or {}

    def zero(name, p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return encode_moment(z, cfg, int8_eligible(
            p.shape, cfg.block, layers.get(name, 1)))
    return {"step": 0,
            "mu": {n: zero(n, p) for n, p in params.items()},
            "nu": {n: zero(n, p) for n, p in params.items()}}


def global_norm(grads) -> torch.Tensor:
    """The float32 l2 norm of every gradient: each tensor's float32 sum of
    squares, added in float64, the root rounded once.  The reference adds
    its stacked leaves' sums in float32 in sorted-name order, so the two
    differ within a few float32 ulps."""
    sums = torch.stack([torch.sum(torch.square(g.float())).double()
                        for g in grads])
    return torch.sqrt(sums.sum()).float()


@torch.no_grad()
def adamw_update(state: dict, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr: Optional[float] = None) -> tuple:
    """One AdamW step, in place: each parameter of `params` takes its new
    value, cast to its dtype, and `state` its new moments (each int8 or
    float32 as it was) and step.  Returns (state, params)."""
    step = state["step"] + 1
    lr_t = _f32(cfg.lr if lr is None else lr)
    names = list(params)
    gnorm = global_norm([grads[n] for n in names])
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    b1c = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32) ** float(step)
    b2c = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32) ** float(step)
    b1, b2 = _f32(cfg.b1), _f32(cfg.b2)
    c1, c2 = _f32(1 - cfg.b1), _f32(1 - cfg.b2)
    wd, eps = _f32(cfg.weight_decay), _f32(cfg.eps)
    for n in names:
        p = params[n]
        dev = p.device
        g = grads[n].float() * scale.to(dev)
        mu = _fma(b1, decode_moment(state["mu"][n], p.shape), c1 * g)
        nu = _fma(b2, decode_moment(state["nu"][n], p.shape), (c2 * g) * g)
        del g
        den = b1c.to(dev) * (torch.sqrt(nu / b2c.to(dev)) + eps)
        pf = p.float()
        x = _fma(pf, wd, mu / den)
        del den
        p.copy_(_fma(-lr_t, x, pf))
        del x, pf
        int8 = isinstance(state["mu"][n], dict)
        state["mu"][n] = encode_moment(mu, cfg, int8)
        state["nu"][n] = encode_moment(nu, cfg, int8)
    state["step"] = step
    return state, params
