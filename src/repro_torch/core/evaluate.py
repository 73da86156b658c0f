"""Evaluation harness: quantize the stored model -> inject bit flips ->
predict (paper Sec. IV-A); port of ``repro.core.evaluate``.

``sweep_under_flips`` fills the (|p_grid|, n_trials) accuracy matrix.  The
JAX package runs the grid as one jit with vmapped trials; here it is a plain
loop on the device.  The stored model is quantized once, every trial then
runs ``corrupted_materialized`` -> predict -> accuracy, and the matrix
stays on the device until one host copy at the end.  The same trial seeds
are reused for every p (common random numbers), so curves are comparable
across p.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.precision import full_f32

INT32_MAX = (1 << 31) - 1


def trial_seeds(generator: torch.Generator, n_trials: int,
                n_leaves: int) -> list:
    """One int32 seed per (trial, stored leaf): n_trials lists of n_leaves,
    drawn like the reference's per-leaf ``randint(key, (), 0, INT32_MAX)``."""
    return torch.randint(0, INT32_MAX, (n_trials, n_leaves),
                         generator=generator).tolist()


@full_f32()
def sweep_under_flips(model, bits: int, p_grid: Sequence[float], h_test,
                      y_test, *, n_trials: int = 3, scope: str = "all",
                      predict_encoded: Optional[Callable] = None,
                      generator: Optional[torch.Generator] = None,
                      seeds: Optional[Sequence[Sequence[int]]] = None
                      ) -> np.ndarray:
    """Full (|p_grid|, n_trials) accuracy matrix.

    ``predict_encoded`` overrides the family's own ``(model, h) -> labels``
    (pass ``repro_torch.api.dispatch.predict_encoded`` for the kernel
    route).  Trial seeds come from ``seeds`` (n_trials rows of one seed per
    ``to_dict()`` leaf without ``enc``) or are drawn from ``generator``
    (default: a CPU generator seeded with 0)."""
    n_trials = int(n_trials)
    if n_trials < 1:
        raise ValueError("n_trials must be >= 1")
    p_grid = [float(p) for p in p_grid]
    if not p_grid:
        return np.zeros((0, n_trials), np.float32)
    pred = (predict_encoded if predict_encoded is not None
            else type(model).predict_encoded)
    qmodel = model.quantized(int(bits))
    n_leaves = len([k for k in qmodel.to_dict() if k != "enc"])
    if seeds is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        seeds = trial_seeds(generator, n_trials, n_leaves)
    seeds = [list(s) for s in seeds]
    if len(seeds) != n_trials:
        raise ValueError(f"{len(seeds)} seed rows for {n_trials} trials")
    h = torch.as_tensor(h_test)
    y = torch.as_tensor(y_test, device=h.device)
    accs = torch.empty((len(p_grid), n_trials), device=h.device)
    for i, p in enumerate(p_grid):
        for t in range(n_trials):
            noisy = qmodel.corrupted_materialized(p, seeds[t], scope)
            accs[i, t] = (pred(noisy, h) == y).float().mean()
    return accs.cpu().numpy()                   # the single host transfer


def evaluate_under_flips(model, bits: int, p: float, h_test, y_test, *,
                         n_trials: int = 3, scope: str = "all",
                         **kw) -> float:
    """Mean accuracy over `n_trials` flip draws at one p (one sweep row)."""
    return float(np.mean(sweep_under_flips(model, bits, [p], h_test, y_test,
                                           n_trials=n_trials, scope=scope,
                                           **kw)))


@full_f32()
def accuracy(model, h_test, y_test) -> float:
    """Clean accuracy of a typed model through its plain predict."""
    h = torch.as_tensor(h_test)
    y = torch.as_tensor(y_test, device=h.device)
    return float((model.predict_encoded(h) == y).float().mean())
