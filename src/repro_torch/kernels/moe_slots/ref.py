"""Plain PyTorch version of the moe_slots kernel (the CPU route of
``MoE.route``, and the version the kernel is held against on the card)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def moe_slots_ref(flat: torch.Tensor, n_experts: int, cap: int):
    """Each choice's slot in its expert's buffer through the (N, E) one-hot:
    flat (N,) int64 expert ids -> (slots (N,) int64, keep (N,) bool)."""
    onehot = F.one_hot(flat, n_experts)                # (T*K, E)
    slot = onehot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1
    keep = slot < cap
    return torch.where(keep, slot, cap - 1), keep
