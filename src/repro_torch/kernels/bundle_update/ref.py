"""Plain PyTorch version of the bundle_update kernel (the CPU route, the
plain training step, and the version the kernel is held against on the
card)."""

from __future__ import annotations

import torch


def bundle_update_ref(m: torch.Tensor, c: torch.Tensor, h: torch.Tensor,
                      lr) -> torch.Tensor:
    """l2n(m + lr * c^T h): (n, D), (B, n), (B, D) -> (n, D) f32."""
    u = m.float() + lr * torch.einsum("bn,bd->nd", c.float(), h.float())
    return u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-12)
