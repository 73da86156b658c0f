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
compiled ``lax.scan``.  A CUDA graph of the loop is later work.

Data-parallel: ``fused_*_dp`` split the example axis into the mesh's data
shards (``launch/mesh.py``: contiguous blocks of the padded rows, as the
reference's ``shard_map`` splits them).  Every step, each shard forms its
minibatch delta in torch (``onlinehd_delta`` / ``refine_delta``); a rank
sums its shards' deltas in shard order, the ranks sum theirs with
``all_reduce`` over the data group, exactly or through the int8
error-feedback ``optim.grad_compress`` (one error buffer a shard, as each
device keeps its own in the reference), and every rank takes the same
``l2n(m + delta)``.  Summing the shards' deltas is the big-batch update,
so the exact dp fit matches the serial fit on the interleaved global
batches up to float summation order.  Each rank is given the whole (h, y)
and reads its own shards' rows.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.api.dispatch import fused_bundle_update
from repro_torch.core.bundling import (refine_bundles, refine_delta,
                                       refine_step, symbol_targets)
from repro_torch.hdc.conventional import (l2_normalize, onlinehd_coefficients,
                                          onlinehd_delta, onlinehd_epoch,
                                          onlinehd_step, pad_rows)
from repro_torch.kernels import common
from repro_torch.launch.mesh import ClassMesh, all_reduce_sum, make_debug_mesh
from repro_torch.optim.grad_compress import compressed_psum
from repro_torch.precision import full_f32

__all__ = ["fused_onlinehd_fit", "fused_refine_bundles",
           "fused_onlinehd_fit_dp", "fused_refine_bundles_dp",
           "shard_permutations"]


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


# ---------------------------------------------------------- data-parallel --

def _allreduce_delta(deltas: list, errs: list, mesh: ClassMesh, axis: str,
                     compress: Optional[str]):
    """Sum the shards' deltas over `axis`: this rank's in shard order, then
    ``all_reduce`` over the axis's group.  ``compress="int8"`` goes through
    ``compressed_psum`` (each shard's int8 reconstruction of delta + error,
    the shards' new errors returned) and, as the reference, takes its mean
    times the shard count."""
    if compress not in (None, "int8"):
        raise ValueError(f"compress must be None or 'int8', not {compress!r}")
    if compress == "int8":
        mean, errs = compressed_psum(deltas, mesh.group(axis), errs)
        return mean * mesh.shape[axis], errs
    total = deltas[0]
    for d in deltas[1:]:
        total = total + d
    return all_reduce_sum(total, mesh.group(axis)), errs


def _pad_rows_to(arrs, multiple: int):
    """Zero-pad axis 0 of each array to the next multiple (no-op rows)."""
    total = -(-arrs[0].shape[0] // multiple) * multiple
    return tuple(pad_rows(a, total) for a in arrs)


def _dp_layout(mesh: Optional[ClassMesh], axis: str, batch_size: int,
               device):
    mesh = make_debug_mesh(device) if mesh is None else mesh
    n_shards = int(mesh.shape[axis])
    return mesh, n_shards, max(1, int(batch_size) // n_shards)


@full_f32()
def fused_onlinehd_fit_dp(protos: torch.Tensor, h: torch.Tensor, y, *,
                          lr: float, batch_size: int, epochs: int,
                          mesh: Optional[ClassMesh] = None,
                          axis: str = "data",
                          compress: Optional[str] = "int8") -> torch.Tensor:
    """Data-parallel OnlineHD fit: examples split over the mesh's `axis`
    shards (default ``make_debug_mesh`` on h's device, one shard a
    rank).

    Each global step takes ``batch_size // shards`` rows of every shard, in
    order; the deltas are summed exactly (``compress=None``) or through the
    int8 error feedback (``"int8"``) before the shared normalisation."""
    if epochs <= 0:
        return protos
    mesh, n_shards, local_bs = _dp_layout(mesh, axis, batch_size,
                                          h.device)
    y = torch.as_tensor(y, device=h.device).to(torch.int64)
    h, y = _pad_rows_to((h, y), n_shards * local_bs)
    n_local = h.shape[0] // n_shards
    shards = [(h[b * n_local:(b + 1) * n_local],
               y[b * n_local:(b + 1) * n_local]) for b in mesh.blocks(axis)]
    errs = [torch.zeros_like(protos, dtype=torch.float32) for _ in shards]
    for _ in range(epochs):
        for i in range(0, n_local, local_bs):
            deltas = [onlinehd_delta(protos, hs[i:i + local_bs],
                                     ys[i:i + local_bs], lr)
                      for hs, ys in shards]
            delta, errs = _allreduce_delta(deltas, errs, mesh, axis, compress)
            protos = l2_normalize(protos + delta)
    return protos


def shard_permutations(n_local: int, epochs: int, n_shards: int, *,
                       seed: int = 0, shards=None, perms=None
                       ) -> torch.Tensor:
    """(epochs, len(shards), n_local) int64 orders of each shard's rows:
    rows of the injected ``perms`` (epochs, n_shards, n_local), or one
    ``torch.randperm`` an epoch from a CPU generator seeded with the pair
    (seed, shard), so a shard's stream does not depend on the world size.
    ``shards`` defaults to every shard."""
    shards = range(n_shards) if shards is None else shards
    if perms is not None:
        perms = torch.as_tensor(perms, dtype=torch.int64)
        if tuple(perms.shape) != (epochs, n_shards, n_local):
            raise ValueError(f"permutations of shape {tuple(perms.shape)}, "
                             f"expected {(epochs, n_shards, n_local)}")
        return perms[:, list(shards)]
    out = []
    for b in shards:
        state = np.random.SeedSequence([int(seed), int(b)]).generate_state(
            1, np.uint64)[0]
        gen = torch.Generator().manual_seed(int(state))
        out.append(torch.stack([torch.randperm(n_local, generator=gen)
                                for _ in range(epochs)]))
    return torch.stack(out, dim=1)


@full_f32()
def fused_refine_bundles_dp(bundles: torch.Tensor, h: torch.Tensor, y,
                            codebook, k: int, *, epochs: int, lr: float,
                            batch_size: int, mesh: Optional[ClassMesh] = None,
                            axis: str = "data",
                            compress: Optional[str] = "int8", seed: int = 0,
                            perms=None) -> torch.Tensor:
    """Data-parallel Eq. 9 refinement: examples split over the mesh's
    `axis` shards; each shard walks its own rows in its own order every
    epoch (``shard_permutations``: injected ``perms`` of shape (epochs,
    shards, rows a shard), else drawn from (seed, shard)), and the deltas
    are summed as in ``fused_onlinehd_fit_dp``."""
    if epochs <= 0:
        return bundles
    mesh, n_shards, local_bs = _dp_layout(mesh, axis, batch_size,
                                          h.device)
    y = torch.as_tensor(y, device=h.device).to(torch.int64)
    targets_y = symbol_targets(codebook, k).to(h.device)[y]
    h, targets_y = _pad_rows_to((h, targets_y), n_shards * local_bs)
    n_local = h.shape[0] // n_shards
    blocks = list(mesh.blocks(axis))
    order = shard_permutations(n_local, epochs, n_shards, seed=seed,
                               shards=blocks, perms=perms).to(h.device)
    shards = [(h[b * n_local:(b + 1) * n_local],
               targets_y[b * n_local:(b + 1) * n_local]) for b in blocks]
    errs = [torch.zeros_like(bundles, dtype=torch.float32) for _ in shards]
    for e in range(epochs):
        for i in range(0, n_local, local_bs):
            deltas = []
            for j, (hs, ts) in enumerate(shards):
                idx = order[e, j, i:i + local_bs]
                deltas.append(refine_delta(bundles, hs.index_select(0, idx),
                                           ts.index_select(0, idx), lr))
            delta, errs = _allreduce_delta(deltas, errs, mesh, axis, compress)
            bundles = l2_normalize(bundles + delta)
    return bundles
