"""Bundle construction (paper Sec. III-C, Eq. 4); port of
``repro.core.bundling``.

    M_j = normalize(sum_i g(B_ij) * H_i)

The Eq. 9 refinement functions come with the training slice.
"""

from __future__ import annotations

import torch

from repro_torch.core.codebook import symbol_weight
from repro_torch.hdc.conventional import l2_normalize


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
