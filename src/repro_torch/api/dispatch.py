"""The predict and corrupt surface that routes to the CUDA kernels (port of
``repro.api.dispatch``).

Predict: a model with the l2 metric whose queries lie on a CUDA device goes
through ``bundle_sim`` and ``profile_decode``; the argmax stays in torch.
Everything else (CPU tensors, the cos and maha metrics) takes the model's
own plain-torch ``predict_encoded``.  Corrupt: each QTensor leaf goes
through ``flip_corrupt`` (the kernel for CUDA tensors, its bit-exact plain
version for CPU tensors).  PyTorch runs eagerly, so no compiled-executable
cache is needed.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Sequence

import torch

from repro_torch.api.models import HDModel, LogHDModel
from repro_torch.core.faults import fault_skip_set, flip_bits_f32
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.hdc.conventional import l2_normalize
from repro_torch.kernels import common
from repro_torch.kernels.bundle_sim.ops import bundle_similarity
from repro_torch.kernels.flip_corrupt.ops import flip_corrupt
from repro_torch.kernels.profile_decode.ops import profile_decode_scores

__all__ = ["predict_fn", "predict_encoded", "corrupt_dequant",
           "corrupt_materialize"]


def _predict_kernel(model: HDModel, h: torch.Tensor) -> torch.Tensor:
    """Kernel-routed l2 predict: argmax over the fused decode scores."""
    if isinstance(model, LogHDModel):
        acts = bundle_similarity(h.contiguous(),
                                 l2_normalize(model.bundles).contiguous())
        scores = profile_decode_scores(acts, model.profiles.float().contiguous())
        return torch.argmax(scores, dim=-1)
    raise TypeError(f"no kernel route for {type(model).__name__}")


def predict_encoded(model: HDModel, h: torch.Tensor,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Labels for pre-encoded queries (B, D) -> (B,).

    QTensor-resident models are dequantized first.  ``use_kernels=None``
    applies the routing rule (l2 on a CUDA device); False forces the plain
    path, which is how a run on the card compares the two."""
    model = model.materialized()
    if use_kernels is None:
        use_kernels = (model.kernel_dispatch
                       and common.use_kernels(h.device, model.metric))
    if use_kernels:
        return _predict_kernel(model, h)
    return model.predict_encoded(h)


def predict_fn(model: HDModel,
               use_kernels: Optional[bool] = None) -> Callable:
    """``(model, h) -> labels`` for `model`'s family."""
    return functools.partial(predict_encoded, use_kernels=use_kernels)


def corrupt_dequant(q: QTensor, p: float, seed: int) -> torch.Tensor:
    """Fused flip -> sign-extend -> dequantize of one QTensor leaf."""
    return flip_corrupt(q.codes, q.scale, q.bits, p, seed)


def corrupt_materialize(model: HDModel, p: float, seeds: Sequence[int],
                        scope: str = "all") -> HDModel:
    """Corrupt + materialize a model's stored state: the sweep's trial body.

    ``seeds`` holds one int32 seed per leaf of ``model.to_dict()`` without
    ``enc``, in that order (LogHD: bundles, profiles, codebook, sigma_inv),
    as the reference splits one key per leaf.  Protected leaves keep their
    slot and are only dequantized.  QTensor leaves go through
    ``flip_corrupt`` with their seed; float leaves (sigma_inv) get IEEE-754
    flips from a generator seeded with theirs — a different stream from the
    reference's threefry, which the l2 decode never reads."""
    skip = fault_skip_set(scope)
    d = {k: v for k, v in model.to_dict().items() if k != "enc"}
    seeds = list(seeds)
    if len(seeds) != len(d):
        raise ValueError(f"{len(seeds)} seeds for {len(d)} leaves {list(d)}")
    out = {}
    for seed, (name, leaf) in zip(seeds, d.items()):
        if name in skip:
            out[name] = dequantize(leaf) if isinstance(leaf, QTensor) else leaf
        elif isinstance(leaf, QTensor):
            out[name] = corrupt_dequant(leaf, p, seed)
        elif leaf.is_floating_point():
            gen = torch.Generator(device=leaf.device).manual_seed(int(seed))
            out[name] = flip_bits_f32(leaf, p, gen)
        else:
            out[name] = leaf
    out["enc"] = model.enc
    return type(model).from_dict(out, **model.aux())
