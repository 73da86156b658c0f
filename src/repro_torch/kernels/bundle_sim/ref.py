"""Plain PyTorch version of the bundle_sim kernel (the CPU route, and the
version the kernel is held against on the card)."""

from __future__ import annotations

import torch


def bundle_similarity_ref(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """A[b, j] = <h_b/||h_b||, M_j>; h (B, D), m (n, D) -> (B, n) f32."""
    h = h.float()
    m = m.float()
    hn = h / (torch.linalg.vector_norm(h, dim=-1, keepdim=True) + 1e-12)
    return hn @ m.T
