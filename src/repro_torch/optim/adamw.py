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

Memory: a plain leaf of more than ``SLICE_ELEMENTS`` elements with
float32 moments (deepseek-v3's embedding) is updated a slice of rows at a
time, its moments in place, by the same arithmetic: the float64
temporaries of the emulated fused multiply-adds stay bounded.

Sharded parameters (DTensors laid out by ``models/sharding.py``): each
moment is a DTensor on its parameter's layout; an int8 moment's codes
are too, and its scale has the parameter's layout with the last axis
whole (``launch/specs.py:114-136`` in the reference), so the update
reads and writes the codes with that axis whole (gathered where the
parameter shards it).  Every elementwise step runs on the local shards.
The clip's global norm adds each shard's sum of squares once (a
replicated shard only on the first rank of its replicas) and
all-reduces the float64 total over the mesh.
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
# a plain leaf with float32 moments above this many elements is updated a
# slice of rows at a time (a 2^27-element slice's float64 temporaries take
# about 1 GB each; deepseek-v3's (129,280, 7,168) embedding whole, 7.4 GB)
SLICE_ELEMENTS = 1 << 27
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


def _dtensor(p) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(p, DTensor)


def _layouts(p):
    """(the parameter's placements, the same with its last axis whole)."""
    from torch.distributed.tensor import Replicate
    last = p.ndim - 1
    pl = list(p.placements)
    return pl, [Replicate() if q.is_shard(last) else q for q in pl]


def _zero_moment_sharded(p, cfg: AdamWConfig, int8: bool):
    """A zero moment of the DTensor `p`, built from local zeros."""
    from torch.distributed.tensor import DTensor
    dm = p.device_mesh
    pl, whole = _layouts(p)
    local = p.to_local()
    z = torch.zeros(local.shape, dtype=torch.float32, device=local.device)
    if cfg.moment_dtype == "float32" or not int8:
        return DTensor.from_local(z, dm, pl, run_check=False)
    codes = torch.zeros(local.shape, dtype=torch.int8, device=local.device)
    # the scale's layout keeps the last axis whole
    scale = torch.ones((*local.shape[:-1], p.shape[-1] // cfg.block),
                       dtype=torch.float32, device=local.device)
    return {"codes": DTensor.from_local(codes, dm, pl, run_check=False),
            "scale": DTensor.from_local(scale, dm, whole, run_check=False)}


def adamw_init(params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
               layers: Optional[Mapping[str, int]] = None) -> dict:
    """Zero moments for `params` (name -> tensor), on each parameter's
    device (a DTensor's on its layout, see the module docstring):
    ``{"step": 0, "mu": {name: moment}, "nu": {...}}``.  `layers` gives,
    by name, how many layers the reference stacks the parameter with
    (``models.convert.stacked_layers``; default 1)."""
    layers = layers or {}

    def zero(name, p):
        int8 = int8_eligible(p.shape, cfg.block, layers.get(name, 1))
        if _dtensor(p):
            return _zero_moment_sharded(p, cfg, int8)
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return encode_moment(z, cfg, int8)
    return {"step": 0,
            "mu": {n: zero(n, p) for n, p in params.items()},
            "nu": {n: zero(n, p) for n, p in params.items()}}


def global_norm(grads) -> torch.Tensor:
    """The float32 l2 norm of every gradient: each tensor's float32 sum of
    squares, added in float64, the root rounded once.  The reference adds
    its stacked leaves' sums in float32 in sorted-name order, so the two
    differ within a few float32 ulps.  DTensor gradients add each local
    shard's sum once (on the first rank of its replicas), and the float64
    total is all-reduced over the mesh: a plain tensor, the same on every
    rank."""
    sums, mesh = [], None
    for g in grads:
        if _dtensor(g):
            mesh = g.device_mesh
            coord = mesh.get_coordinate()
            first = all(c == 0 for c, q in zip(coord, g.placements)
                        if not q.is_shard())
            g = g.to_local() if first else g.to_local()[:0]
        sums.append(torch.sum(torch.square(g.float())).double())
    total = torch.stack(sums).sum()
    if mesh is not None:
        import torch.distributed._functional_collectives as funcol
        for m in range(mesh.ndim):
            total = funcol.wait_tensor(funcol.all_reduce(
                total, "sum", mesh.get_group(m)))
    return torch.sqrt(total).float()


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
    k = (scale, b1c, b2c, b1, b2, c1, c2, wd, eps, lr_t)
    for n in names:
        p, g = params[n], grads[n]
        mu_old, nu_old = state["mu"][n], state["nu"][n]
        if (not _dtensor(p) and p.numel() > SLICE_ELEMENTS
                and not isinstance(mu_old, dict)):
            # a large leaf a slice of rows at a time, its float32 moments
            # updated in place: the float64 temporaries stay bounded
            rows = max(1, SLICE_ELEMENTS // (p.numel() // p.shape[0]))
            for r in range(0, p.shape[0], rows):
                sl = slice(r, r + rows)
                mu, nu = _leaf_step(p[sl], g[sl], mu_old[sl], nu_old[sl], k)
                mu_old[sl].copy_(mu)
                nu_old[sl].copy_(nu)
                del mu, nu
            continue
        if _dtensor(p):
            g = g.redistribute(p.device_mesh, p.placements).to_local()
            p = p.to_local()
        mu, nu = _leaf_step(p, g, _moment_in(mu_old, p.shape),
                            _moment_in(nu_old, p.shape), k)
        state["mu"][n] = _moment_out(mu, mu_old, params[n], cfg)
        state["nu"][n] = _moment_out(nu, nu_old, params[n], cfg)
    state["step"] = step
    return state, params


def _leaf_step(p: torch.Tensor, g: torch.Tensor, mu_in: torch.Tensor,
               nu_in: torch.Tensor, k: tuple) -> tuple:
    """One leaf's AdamW arithmetic: writes the new value into `p` (a local
    tensor or a view of one) and returns its new float32 moments."""
    scale, b1c, b2c, b1, b2, c1, c2, wd, eps, lr_t = k
    dev = p.device
    g = g.float() * scale.to(dev)
    mu = _fma(b1, mu_in, c1 * g)
    nu = _fma(b2, nu_in, (c2 * g) * g)
    del g
    den = b1c.to(dev) * (torch.sqrt(nu / b2c.to(dev)) + eps)
    pf = p.float()
    x = _fma(pf, wd, mu / den)
    del den
    p.copy_(_fma(-lr_t, x, pf))
    return mu, nu


def _moment_in(m, local_shape) -> torch.Tensor:
    """The float32 moment of a stored one, as a local tensor in the
    parameter's layout."""
    if not _dtensor(m if not isinstance(m, dict) else m["codes"]):
        return decode_moment(m, local_shape)
    if not isinstance(m, dict):
        return m.to_local()
    from torch.distributed.tensor import DTensor
    codes, scale = m["codes"], m["scale"]
    dm, pl = codes.device_mesh, codes.placements
    whole = scale.placements
    c = codes.redistribute(dm, whole).to_local()
    mw = decode_moment({"codes": c, "scale": scale.to_local()}, c.shape)
    return DTensor.from_local(mw, dm, whole, run_check=False).redistribute(
        dm, pl).to_local()


def _moment_out(x: torch.Tensor, old, param, cfg: AdamWConfig):
    """A moment stored as `old` was (float32 or int8, plain or on the
    parameter's layout) from its new float32 local value `x`."""
    int8 = isinstance(old, dict)
    if not _dtensor(param):
        return encode_moment(x, cfg, int8)
    from torch.distributed.tensor import DTensor
    dm = param.device_mesh
    pl, whole = _layouts(param)
    if not int8:
        return DTensor.from_local(x, dm, pl, run_check=False)
    xw = DTensor.from_local(x, dm, pl, run_check=False).redistribute(
        dm, whole).to_local()
    enc = encode_moment(xw, cfg, True)
    return {"codes": DTensor.from_local(enc["codes"], dm, whole,
                                        run_check=False).redistribute(dm, pl),
            "scale": DTensor.from_local(enc["scale"], dm, whole,
                                        run_check=False)}
