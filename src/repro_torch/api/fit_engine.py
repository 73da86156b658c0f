"""The training engine's epoch loops and their kernel steps (port of
``repro.api.fit_engine``, single device).

Every minibatch of OnlineHD retraining (conventional refinement, SparseHD
retraining) and of Eq. 9 refinement (LogHD, hybrid) is one
``bundle_update`` step: its coefficients (B, n) are formed in torch, and the
scatter-add ``lr * coeff^T h`` with the row renormalisation runs in the
kernel on the card (its plain version on the CPU).  ``use_kernel=None``
applies the device's rule (the kernel steps on a CUDA device, the plain
steps of ``hdc.conventional`` / ``core.bundling`` on the CPU); False forces
the plain steps, which is how a run on the card compares the two.  The two
differ in float summation order, so they agree to allclose, not bitwise.

The epochs run as eager Python loops; the reference runs them as one
compiled ``lax.scan``.  A CUDA graph of the loop and the data-parallel
``fused_*_dp`` fits are later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.dispatch import fused_bundle_update
from repro_torch.core.bundling import refine_bundles, refine_step
from repro_torch.hdc.conventional import (onlinehd_coefficients,
                                          onlinehd_epoch, onlinehd_step)
from repro_torch.kernels import common
from repro_torch.precision import full_f32

__all__ = ["fused_onlinehd_fit", "fused_refine_bundles"]


def _onlinehd_step_kernel(protos, hh, yy, lr):
    """OnlineHD minibatch update through ``bundle_update``: the pull/push
    one-hots folded into one (B, C) coefficient matrix."""
    return fused_bundle_update(protos, onlinehd_coefficients(protos, hh, yy),
                               hh, lr, use_kernel=True)


def _refine_step_kernel(bundles, hh, tt, lr):
    """Eq. 9 minibatch update through ``bundle_update``: coefficients are
    the (B, n) activation errors t - A."""
    return fused_bundle_update(bundles, tt - hh @ bundles.T, hh, lr,
                               use_kernel=True)


def _use_kernel(use_kernel: Optional[bool], t: torch.Tensor) -> bool:
    return (common.kernel_device(t.device) if use_kernel is None
            else bool(use_kernel))


@full_f32()
def fused_onlinehd_fit(protos: torch.Tensor, h: torch.Tensor, y, *,
                       lr: float, batch_size: int, epochs: int,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
    """All OnlineHD refinement epochs: ``epochs`` in-order passes of
    ``batch_size`` minibatches over (h, y)."""
    if epochs <= 0:
        return protos
    step = (_onlinehd_step_kernel if _use_kernel(use_kernel, protos)
            else onlinehd_step)
    y = torch.as_tensor(y, device=h.device).to(torch.int64)
    for _ in range(epochs):
        protos = onlinehd_epoch(protos, h, y, lr, int(batch_size), step)
    return protos


@full_f32()
def fused_refine_bundles(bundles: torch.Tensor, h: torch.Tensor, y, codebook,
                         k: int, *, epochs: int, lr: float,
                         batch_size: int = 1, seed: int = 0, perms=None,
                         use_kernel: Optional[bool] = None) -> torch.Tensor:
    """All Eq. 9 refinement epochs (``core.bundling.refine_bundles`` with the
    kernel step on the card); `seed` and `perms` choose the example orders
    as there."""
    step = (_refine_step_kernel if _use_kernel(use_kernel, bundles)
            else refine_step)
    return refine_bundles(bundles, h, y, codebook, k, epochs=epochs, lr=lr,
                          batch_size=batch_size, seed=seed, perms=perms,
                          step=step)
