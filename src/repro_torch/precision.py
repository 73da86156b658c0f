"""The port's one float32 matmul guard.

The JAX package is held at float32 tolerances, and so is the port, but on
the card a float32 ``torch.matmul`` may run in TF32 (about three decimal
digits) when ``torch.backends.cuda.matmul.allow_tf32`` is set, and a float32
convolution does by default.  ``full_f32()`` turns both off for the block it
guards, and restores the caller's settings after it.  The entry points of
the fit, refine and predict paths run under it (as a decorator), so every
matmul they make is full float32 whatever the process set globally.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_f32():
    """Full float32 matmuls and convolutions inside the block; usable as a
    decorator."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    matmul.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def in_full_f32() -> bool:
    """True while float32 matmuls and convolutions run in full float32."""
    return not (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32)
