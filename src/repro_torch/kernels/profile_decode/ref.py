"""Plain PyTorch version of the profile_decode kernel."""

from __future__ import annotations

import torch


def profile_decode_scores_ref(acts: torch.Tensor,
                              profiles: torch.Tensor) -> torch.Tensor:
    """scores[b, c] = -||A_b - P_c||^2 : (B, n), (C, n) -> (B, C) f32."""
    a = acts.float()
    p = profiles.float()
    return -torch.sum((a[:, None, :] - p[None, :, :]) ** 2, dim=-1)
