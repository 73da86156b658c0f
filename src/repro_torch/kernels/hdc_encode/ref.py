"""Plain PyTorch versions of the hdc_encode kernel (the CPU route, and the
versions the kernel is held against on the card)."""

from __future__ import annotations

import torch

from repro_torch.hdc.conventional import l2_normalize

KINDS = ("cos", "rp", "rp_sign")


def _nonlin(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
            kind: str) -> torch.Tensor:
    """nonlin(x W) in float32, before any centring or normalisation."""
    z = x.float() @ w.float()
    if kind == "cos":
        return torch.cos(z + bias) * torch.sin(z)
    if kind == "rp":
        return z
    if kind == "rp_sign":
        return torch.sign(z)
    raise ValueError(f"unknown encoder kind: {kind}")


def hdc_encode_ref(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   center: torch.Tensor, kind: str = "cos") -> torch.Tensor:
    """The TPU kernel's contract: nonlin(x W) - center, unnormalised;
    x (B, F), w (F, D), bias and center (D,) -> (B, D) float32."""
    return _nonlin(x, w, bias, kind) - center


def hdc_encode_plain(x: torch.Tensor, proj: torch.Tensor, bias: torch.Tensor,
                     center: torch.Tensor, kind: str = "cos") -> torch.Tensor:
    """The whole encode: l2n(l2n(nonlin(x W)) - center), as
    ``repro.kernels.hdc_encode.ops.hdc_encode`` and
    ``repro.hdc.encoders.encode`` return it."""
    return l2_normalize(l2_normalize(_nonlin(x, proj, bias, kind)) - center)
