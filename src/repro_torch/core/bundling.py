"""Bundle construction and Eq. 9 refinement (paper Sec. III-C, III-F); port
of ``repro.core.bundling``.

    M_j = normalize(sum_i g(B_ij) * H_i)                        (Eq. 4)
    M_j <- M_j + eta * (t(B_yj) - A_j) * phi(x), renormalized   (Eq. 9)

The reference shuffles each epoch with ``jax.random.permutation``, which no
torch generator reproduces: here the permutations come from a CPU
``torch.Generator`` seeded with the config seed, or are injected as an
(epochs, N) integer array (the parity tests inject the reference's).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.codebook import symbol_weight
from repro_torch.hdc.conventional import l2_normalize, pad_rows


def build_bundles(prototypes: torch.Tensor, codebook, k: int,
                  normalize: bool = True, bipolar: bool = False
                  ) -> torch.Tensor:
    """M_j = sum_i g(B_ij) H_i : (C, D), (C, n) -> (n, D).

    ``bipolar=True`` uses the refinement targets t(s) = 2 g(s) - 1 as the
    weights (beyond-paper initialisation at the Eq. 9 fixed point)."""
    book = torch.as_tensor(codebook, device=prototypes.device)
    g = symbol_weight(book, k)                            # (C, n)
    if bipolar:
        g = 2.0 * g - 1.0
    m = g.T @ prototypes
    return l2_normalize(m) if normalize else m


def symbol_targets(codebook, k: int) -> torch.Tensor:
    """t(B) = 2 g(B) - 1 in [-1, 1]: (C, n) float targets."""
    return 2.0 * symbol_weight(torch.as_tensor(codebook), k) - 1.0


def refine_delta(bundles: torch.Tensor, h: torch.Tensor,
                 targets_y: torch.Tensor, lr) -> torch.Tensor:
    """The raw Eq. 9 minibatch delta lr * (t - A)^T h, before adding and
    re-normalizing."""
    err = targets_y - h @ bundles.T                      # (B, n)
    return torch.einsum("bn,bd->nd", err, h) * lr


def refine_step(bundles: torch.Tensor, h: torch.Tensor,
                targets_y: torch.Tensor, lr) -> torch.Tensor:
    """One minibatched Eq. 9 update of L2-normalized bundles (n, D) from
    queries h (B, D) and their code-implied targets t(B_y) (B, n)."""
    return l2_normalize(bundles + refine_delta(bundles, h, targets_y, lr))


def epoch_permutations(n: int, epochs: int, *, seed: int = 0, perms=None,
                       device=None) -> torch.Tensor:
    """(epochs, n) int64 example orders on `device`: ``perms`` as given, or
    one ``torch.randperm`` per epoch from a CPU generator seeded with
    `seed`."""
    if perms is None:
        generator = torch.Generator().manual_seed(int(seed))
        perms = torch.stack([torch.randperm(n, generator=generator)
                             for _ in range(epochs)])
    perms = torch.as_tensor(perms, dtype=torch.int64, device=device)
    if tuple(perms.shape) != (epochs, n):
        raise ValueError(f"permutations of shape {tuple(perms.shape)}, "
                         f"expected {(epochs, n)}")
    return perms


def refine_epoch(bundles: torch.Tensor, perm: torch.Tensor, h: torch.Tensor,
                 targets_y: torch.Tensor, lr, batch_size: int,
                 step: Callable = refine_step) -> torch.Tensor:
    """One Eq. 9 pass over the examples in the order `perm` (N,).

    Each minibatch gathers its rows (``index_select``), so the permuted
    training set is never copied whole; the last one is zero-padded, an
    exact no-op (see ``pad_batches``).  ``step`` is the minibatch update
    (the fit engine passes its kernel step)."""
    for i in range(0, perm.shape[0], batch_size):
        idx = perm[i:i + batch_size]
        bundles = step(bundles,
                       pad_rows(h.index_select(0, idx), batch_size),
                       pad_rows(targets_y.index_select(0, idx), batch_size),
                       lr)
    return bundles


def refine_bundles(bundles: torch.Tensor, h: torch.Tensor, y, codebook,
                   k: int, *, epochs: int, lr: float, batch_size: int = 1,
                   seed: int = 0, perms=None,
                   step: Callable = refine_step) -> torch.Tensor:
    """T epochs of Eq. 9 over a randomly ordered training set.

    batch_size=1 is the paper's per-example update (Algorithm 1, step 5).
    Orders come from ``epoch_permutations`` (injected `perms`, else drawn
    from `seed`); ``step`` as in ``refine_epoch``."""
    if epochs <= 0:
        return bundles
    n = h.shape[0]
    targets_y = symbol_targets(codebook, k).to(h.device)[
        torch.as_tensor(y, device=h.device).to(torch.int64)]
    order = epoch_permutations(n, epochs, seed=seed, perms=perms,
                               device=h.device)
    bs = max(1, min(int(batch_size), n))
    for e in range(epochs):
        bundles = refine_epoch(bundles, order[e], h, targets_y, lr, bs,
                               step)
    return bundles
