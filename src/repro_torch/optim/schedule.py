"""LR schedules (port of ``repro.optim.schedule``)."""

from __future__ import annotations

import torch


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int,
                    total_steps: int, final_frac: float = 0.1) -> float:
    """Linear warmup to `peak_lr` over `warmup_steps`, then a cosine decay
    to ``final_frac * peak_lr`` at `total_steps`, flat after it.

    Computed in float32 in the reference's order of operations (Python
    numbers enter as float32, as jax's weakly typed scalars do); returns a
    Python float that holds the float32 value.  XLA's float32 cosine on
    the CPU lands up to 7 ulps from the float64 value, and XLA folds the
    warmup's division into a product by a rounded constant, so the two
    agree within 8 float32 ulps (``tests/test_torch_optim.py``)."""
    s = torch.tensor(float(step), dtype=torch.float32)
    warm = peak_lr * s / max(warmup_steps, 1)
    prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(torch.pi * prog)))
    return float(torch.where(s < warmup_steps, warm, cos))
