"""Plain PyTorch version of the loghd_head kernel (the CPU route, and the
version the kernel is held against on the card)."""

from __future__ import annotations

import torch


def loghd_head_parts_ref(h: torch.Tensor, m: torch.Tensor,
                         p: torch.Tensor) -> tuple:
    """(logits (B, V), activations A = h M^T (B, n)), both float32: what
    the kernel writes into its one buffer."""
    a = h.float() @ m.float().T                                 # (B, n)
    pf = p.float()
    return (2.0 * a @ pf.T
            - (pf * pf).sum(dim=-1)[None, :]
            - (a * a).sum(dim=-1)[:, None]), a


def loghd_head_logits_ref(h: torch.Tensor, m: torch.Tensor,
                          p: torch.Tensor) -> torch.Tensor:
    """logits[b, v] = -||h_b M^T - P_v||^2; h (B, D), m (n, D), p (V, n),
    all widened to float32 first -> (B, V) float32."""
    return loghd_head_parts_ref(h, m, p)[0]
