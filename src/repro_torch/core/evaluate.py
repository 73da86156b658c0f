"""Evaluation harness: quantize the stored model -> inject bit flips ->
predict (paper Sec. IV-A); port of ``repro.core.evaluate``.

``sweep_under_flips`` fills the (|p_grid|, n_trials) accuracy matrix.  The
JAX package runs the grid as one jit, scanning p-chunks and vmapping the
(p, trial) points of a chunk; here the stored model is quantized once,
each p-chunk's (p, trial) points are corrupted by one batched
``corrupted_materialized_grid`` call (one ``flip_corrupt`` launch on the
card), and predict -> accuracy then runs point by point into the device
matrix, which stays on the device until one host copy at the end.  The
same trial seeds are reused for every p (common random numbers), so curves
are comparable across p.

``fault_model=`` selects a device-noise model of ``repro_torch.faults``;
``p_grid`` is then its severity grid.  ``None`` and ``"iid"`` take the
``flip_corrupt`` route above; every other model corrupts each point in
torch ops on the model's device (one point after another: the reference
vmaps them), from the same trial seeds at every severity.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.quantize import dequantize_tree
from repro_torch.precision import full_f32

INT32_MAX = (1 << 31) - 1


def materialize(model):
    """Dequantize any QTensor leaves of a tree or typed model back to
    float32 for inference."""
    return dequantize_tree(model)


def trial_seeds(generator: torch.Generator, n_trials: int,
                n_leaves: int) -> list:
    """One int32 seed per (trial, stored leaf): n_trials lists of n_leaves,
    drawn like the reference's per-leaf ``randint(key, (), 0, INT32_MAX)``."""
    return torch.randint(0, INT32_MAX, (n_trials, n_leaves),
                         generator=generator).tolist()


def resolve_fault_model(fault_model):
    """None stays None (the default iid route), a name goes through the
    ``repro_torch.faults`` registry, and a ``FaultModel`` passes through."""
    if fault_model is None or not isinstance(fault_model, str):
        return fault_model
    from repro_torch.faults import make_fault_model
    return make_fault_model(fault_model)


def pad_p_grid(p_grid: Sequence[float], chunk: int) -> list:
    """The p-grid cut into chunks of `chunk` values, the last one padded by
    repeating the final real p (the reference's ``pad_p_grid``: the padded
    rows are evaluated only where a chunk needs its full shape and are
    sliced off by the caller).

    >>> pad_p_grid([1.0, 2.0, 3.0], 2)
    [[1.0, 2.0], [3.0, 3.0]]
    """
    p_grid = list(p_grid)
    n_chunks = -(-len(p_grid) // chunk)
    padded = p_grid + [p_grid[-1]] * (n_chunks * chunk - len(p_grid))
    return [padded[c * chunk:(c + 1) * chunk] for c in range(n_chunks)]


@full_f32()
def sweep_under_flips(model, bits: int, p_grid: Sequence[float], h_test,
                      y_test, *, n_trials: int = 3, scope: str = "all",
                      predict_encoded: Optional[Callable] = None,
                      generator: Optional[torch.Generator] = None,
                      seeds: Optional[Sequence[Sequence[int]]] = None,
                      p_chunk: Optional[int] = None,
                      fault_model=None) -> np.ndarray:
    """Full (|p_grid|, n_trials) accuracy matrix.

    ``predict_encoded`` overrides the family's own ``(model, h) -> labels``
    (pass ``repro_torch.api.dispatch.predict_encoded`` for the kernel
    route).  Trial seeds come from ``seeds`` (n_trials rows of one seed per
    ``to_dict()`` leaf without ``enc``) or are drawn from ``generator``
    (default: a CPU generator seeded with 0).  ``p_chunk`` has the
    reference's meaning: the grid runs in chunks of ``max(1, min(p_chunk,
    |p_grid|))`` p values (default: the whole grid in one chunk), the last
    padded by repeating the final p; a chunk's chunk x n_trials models are
    corrupted by one ``flip_corrupt`` launch and held at once, so a smaller
    chunk bounds that memory.  The padded rows are corrupted with their
    chunk but not predicted.  ``fault_model`` (a registered name or a
    ``FaultModel``) reads ``p_grid`` as its severity grid; the default and
    ``"iid"`` make one ``flip_corrupt`` launch a chunk, the other models
    none."""
    n_trials = int(n_trials)
    if n_trials < 1:
        raise ValueError("n_trials must be >= 1")
    p_grid = [float(p) for p in p_grid]
    n_p = len(p_grid)
    if not p_grid:
        return np.zeros((0, n_trials), np.float32)
    fault_model = resolve_fault_model(fault_model)
    # kernel-eligible models (iid) make the default call: one flip_corrupt
    # launch a chunk, the same seeds, the same bits
    zoo = ({} if fault_model is None or fault_model.kernel_eligible
           else {"fault_model": fault_model})
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
    chunk = n_p if p_chunk is None else max(1, min(int(p_chunk), n_p))
    h = torch.as_tensor(h_test)
    y = torch.as_tensor(y_test, device=h.device)
    accs = torch.empty((n_p, n_trials), device=h.device)
    for c, ps in enumerate(pad_p_grid(p_grid, chunk)):
        noisy = qmodel.corrupted_materialized_grid(
            [p for p in ps for _ in range(n_trials)], seeds * len(ps), scope,
            **zoo)
        for k, model_k in enumerate(noisy):
            i, t = c * chunk + k // n_trials, k % n_trials
            if i < n_p:
                accs[i, t] = (pred(model_k, h) == y).float().mean()
    return accs.cpu().numpy()                   # the single host transfer


def evaluate_under_flips(model, bits: int, p: float, h_test, y_test, *,
                         n_trials: int = 3, scope: str = "all",
                         **kw) -> float:
    """Mean accuracy over `n_trials` flip draws at one p (one sweep row);
    keywords as ``sweep_under_flips`` (``fault_model=`` among them, `p`
    then its severity)."""
    return float(np.mean(sweep_under_flips(model, bits, [p], h_test, y_test,
                                           n_trials=n_trials, scope=scope,
                                           **kw)))


@full_f32()
def accuracy(model, h_test, y_test) -> float:
    """Clean accuracy of a typed model through its plain predict."""
    h = torch.as_tensor(h_test)
    y = torch.as_tensor(y_test, device=h.device)
    return float((model.predict_encoded(h) == y).float().mean())
