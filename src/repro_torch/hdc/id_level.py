"""Classic ID-level HDC encoding (port of ``repro.hdc.id_level``): bipolar,
zero-mean by construction.

  phi(x) = sum_f ID_f ⊙ L_{q(x_f)}

  ID_f — one random bipolar {-1,+1}^D identity hypervector per feature,
  L_l  — ``levels`` correlated level hypervectors from a shared uniform
         threshold vector t in [0,1]^D and bipolar endpoints lo / hi:
         L_l[d] = hi[d] if t[d] <= l / (levels-1) else lo[d], so
         Hamming(L_a, L_b) grows linearly in |a-b|,
  q    — a per-feature uniform quantizer over [-clip, clip].

As in the reference, phi is evaluated per level l as a dense (B, F) x (F, D)
product, ``(q == l) @ (ID * L_l)``, summed over the levels and L2-normalised
once.  Every term is ±1 or 0/1, so the sum before the normalisation is a
sum of at most F integers: exact in float32 (and under TF32) in any order,
the same bits on the CPU and on the card.  The products are plain
``torch.matmul``: the reference computes them outside any Pallas kernel.

The reference draws ``ids`` and the level table with threefry, which a
``torch.Generator`` cannot reproduce; ``from_reference`` carries its
arrays across.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device
from repro_torch.precision import full_f32

__all__ = ["IDLevelConfig", "init_id_level", "quantize_features",
           "id_level_sums", "encode_id_level", "fit_id_level",
           "from_reference"]


@dataclasses.dataclass(frozen=True)
class IDLevelConfig:
    in_features: int
    dim: int = 10_000
    levels: int = 16
    clip: float = 3.0            # quantizer range for standardized features
    seed: int = 0


def _bipolar(shape, generator: torch.Generator) -> torch.Tensor:
    bits = torch.randint(0, 2, shape, generator=generator,
                         device=generator.device)
    return 2.0 * bits.to(torch.float32) - 1.0


def init_id_level(cfg: IDLevelConfig, device=None,
                  generator: Optional[torch.Generator] = None) -> dict:
    """``{"ids": (F, D), "levels": (levels, D)}`` float32 ±1 on `device`
    (None means "cuda"), drawn from `generator` (default: one on `device`
    seeded with ``cfg.seed``) in the order ids, lo, hi, thresholds."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    ids = _bipolar((cfg.in_features, cfg.dim), generator)
    lo = _bipolar((cfg.dim,), generator)
    hi = _bipolar((cfg.dim,), generator)
    thresh = torch.rand((cfg.dim,), generator=generator,
                        device=generator.device)
    fracs = (torch.arange(cfg.levels, dtype=torch.float32,
                          device=generator.device) / (cfg.levels - 1))
    table = torch.where(thresh[None, :] <= fracs[:, None], hi, lo)
    return {"ids": ids.to(device), "levels": table.to(device)}


def from_reference(params: dict, device=None) -> dict:
    """The reference's ``{"ids", "levels"}`` arrays (numpy) as the port's
    float32 tensors on `device` (None means "cuda")."""
    device = resolve_device(device)
    return {k: torch.from_numpy(np.array(params[k], np.float32)).to(device)
            for k in ("ids", "levels")}


def quantize_features(x: torch.Tensor, cfg: IDLevelConfig) -> torch.Tensor:
    """(B, F) float -> (B, F) int32 level indices (round half to even)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    scaled = (torch.clamp(x, -cfg.clip, cfg.clip) + cfg.clip) / (2 * cfg.clip)
    return torch.clamp(torch.round(scaled * (cfg.levels - 1)), 0,
                       cfg.levels - 1).to(torch.int32)


@full_f32()
def id_level_sums(params: dict, x, cfg: IDLevelConfig) -> torch.Tensor:
    """phi(x) before the normalisation: (B, F) -> (B, D) float32 integers,
    on the params' device."""
    ids, table = params["ids"], params["levels"]
    q = quantize_features(torch.as_tensor(x, device=ids.device), cfg)
    h = torch.zeros((q.shape[0], cfg.dim), dtype=torch.float32,
                    device=ids.device)
    for level in range(cfg.levels):
        mask = (q == level).to(torch.float32)
        h = h + mask @ (ids * table[level][None, :])
    return h


def encode_id_level(params: dict, x, cfg: IDLevelConfig) -> torch.Tensor:
    """phi(x): (B, F) -> (B, D), L2-normalised."""
    h = id_level_sums(params, x, cfg)
    return h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-12)


def fit_id_level(cfg: IDLevelConfig, x_train, device=None,
                 generator: Optional[torch.Generator] = None):
    """(params, h_train), as ``hdc.encoders.fit_encoder`` returns; no DC
    calibration: the encoding is zero-mean by construction."""
    params = init_id_level(cfg, device=device, generator=generator)
    return params, encode_id_level(params, x_train, cfg)
