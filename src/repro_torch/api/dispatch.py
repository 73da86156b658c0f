"""The predict, training-step, LM-head and corrupt surface that routes to
the CUDA kernels (port of ``repro.api.dispatch``).

Predict: a model with the l2 metric whose queries lie on a CUDA device goes
through ``bundle_sim`` (every family) and ``profile_decode`` (LogHD,
hybrid); the argmax stays in torch.  Everything else (CPU tensors, the cos
and maha metrics) takes the model's own plain-torch ``predict_encoded``.
Training: ``fused_bundle_update`` is the minibatch step of the fit engine,
through ``bundle_update``.  LM head: ``loghd_head_scores`` is the
decoder LM's LogHD vocab head, through ``loghd_head``, differentiable for
LM training.  Corrupt: the
QTensor leaves of a model at a chunk of grid points go through one
``flip_corrupt_grid`` call (the kernel for CUDA tensors, its bit-exact
plain version for CPU tensors), under the default iid model; the other
models of ``repro_torch.faults`` run in torch ops on the model's device.
PyTorch runs eagerly, so no compiled-executable cache is needed;
``clear_cache`` still resets every cache a later layer registers (the
serving layer's bucket bookkeeping).
"""

from __future__ import annotations

import functools
import numbers
from typing import Callable, Optional, Sequence

import torch

from repro_torch.api.models import (ConventionalModel, HDModel, HybridModel,
                                    LogHDModel, SparseHDModel)
from repro_torch.core.faults import (GeneratorDraw, fault_skip_set,
                                     flip_bits_f32)
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.hdc.conventional import l2_normalize
from repro_torch.kernels import common
from repro_torch.kernels.bundle_sim.ops import bundle_similarity
from repro_torch.kernels.bundle_update.ops import bundle_update
from repro_torch.kernels.bundle_update.ref import bundle_update_ref
from repro_torch.kernels.flip_corrupt.ops import flip_corrupt_grid
from repro_torch.kernels.loghd_head.ops import loghd_head_autograd
from repro_torch.kernels.loghd_head.ref import loghd_head_logits_ref
from repro_torch.kernels.profile_decode.ops import profile_decode_scores
from repro_torch.precision import full_f32

__all__ = ["predict_fn", "predict_encoded", "loghd_head_scores",
           "fused_bundle_update", "corrupt_materialize",
           "corrupt_materialize_grid",
           "register_cache_clearer", "clear_cache"]


def _activations(h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """bundle_sim of queries against the l2-normalised rows of m."""
    return bundle_similarity(h.contiguous(), l2_normalize(m).contiguous())


def _decode(h: torch.Tensor, m: torch.Tensor,
            profiles: torch.Tensor) -> torch.Tensor:
    """bundle_sim, then profile_decode as its programmatic dependent: the
    profiles are made float32 and contiguous before bundle_sim launches, so
    the kernel just before profile_decode is bundle_sim, which does not
    write them."""
    p = profiles.float().contiguous()
    acts = _activations(h, m)
    return torch.argmax(profile_decode_scores(acts, p, pdl=True), dim=-1)


def _predict_kernel(model: HDModel, h: torch.Tensor) -> torch.Tensor:
    """Kernel-routed l2 predict: argmax over the fused scores."""
    if isinstance(model, ConventionalModel):
        return torch.argmax(_activations(h, model.protos), dim=-1)
    if isinstance(model, SparseHDModel):
        h_s = l2_normalize(h[:, model.keep])
        return torch.argmax(_activations(h_s, model.protos), dim=-1)
    if isinstance(model, LogHDModel):
        return _decode(h, model.bundles, model.profiles)
    if isinstance(model, HybridModel):
        h_s = l2_normalize(h[:, model.keep])
        return _decode(h_s, model.bundles, model.profiles)
    raise TypeError(f"no kernel route for {type(model).__name__}")


@full_f32()
def predict_encoded(model: HDModel, h: torch.Tensor,
                    use_kernels: Optional[bool] = None) -> torch.Tensor:
    """Labels for pre-encoded queries (B, D) -> (B,).

    QTensor-resident models are dequantized first.  ``use_kernels=None``
    applies the routing rule (l2 on a CUDA device); False forces the plain
    path, which is how a run on the card compares the two."""
    model = model.materialized()
    if use_kernels is None:
        use_kernels = (model.kernel_dispatch and common.use_kernels(
            h.device, getattr(model, "metric", "l2")))
    if use_kernels:
        return _predict_kernel(model, h)
    return model.predict_encoded(h)


def predict_fn(model: HDModel,
               use_kernels: Optional[bool] = None) -> Callable:
    """``(model, h) -> labels`` for `model`'s family."""
    return functools.partial(predict_encoded, use_kernels=use_kernels)


def loghd_head_scores(x: torch.Tensor, bundles: torch.Tensor,
                      profiles: torch.Tensor) -> torch.Tensor:
    """LogHD LM-head logits -||x M^T - P_v||^2: (..., D) -> (..., V) f32.

    Every call goes through ``loghd_head``: the kernel for CUDA tensors (or
    an error), its plain version for CPU tensors; one launch a call.  The
    reference casts the profiles to float32 here; ``loghd_head`` widens
    them itself (exactly), so the stored profiles pass as they are.

    Gradients: with grad mode on and an input requiring one (training),
    the call is ``loghd_head_autograd``, whose backward runs float32 torch
    ops on the (rows, n) activations the forward kept, on both routes, as
    ``jax.grad`` differentiates the jnp expansion in the reference; a
    training step therefore launches the kernel once per forward (and once
    more per recomputation under a checkpoint).  Under ``no_grad``
    (serving, ``decode_step``) nothing is kept.

    Unlike the reference's jnp branch, which rounds ``x @ bundles.T`` to
    the inputs' dtype before widening, both routes widen x and the bundles
    first, as the Pallas kernel does: at bfloat16 the CPU result is the
    kernel's, not the JAX package's CPU path's."""
    lead = x.shape[:-1]
    h = x.reshape(-1, x.shape[-1]).contiguous()
    if h.is_meta:
        # the dry run's meta tensors hold no data: the plain expression
        # gives the logits' shape (and its FLOPs to a counter)
        out = loghd_head_logits_ref(h, bundles, profiles)
    else:
        out = loghd_head_autograd(h, bundles.contiguous(),
                                  profiles.contiguous())
    return out.reshape(*lead, profiles.shape[0])


def fused_bundle_update(m: torch.Tensor, coeff: torch.Tensor,
                        h: torch.Tensor, lr,
                        use_kernel: Optional[bool] = None) -> torch.Tensor:
    """One training minibatch update l2n(m + lr * coeff^T h).

    ``use_kernel=None`` or True: ``bundle_update``, the kernel for CUDA
    tensors (or an error: there is no fallback) and its plain einsum +
    ``l2_normalize`` version for CPU tensors.  False: that plain version on
    any device."""
    if use_kernel is False:
        return bundle_update_ref(m, coeff, h, lr)
    return bundle_update(m, coeff, h, lr)


def corrupt_materialize(model: HDModel, p: float, seeds: Sequence,
                        scope: str = "all", fault_model=None) -> HDModel:
    """Corrupt + materialize a model's stored state: the sweep's trial body.

    ``seeds`` holds one seed per leaf of ``model.to_dict()`` without
    ``enc``, in that order (LogHD: bundles, profiles, codebook, sigma_inv;
    SparseHD: protos, keep).  Protected leaves keep their slot and are only
    dequantized.  ``fault_model=None`` and kernel-eligible models (iid):
    int seeds; QTensor leaves go through ``flip_corrupt`` with their seed;
    float leaves (sigma_inv) get IEEE-754 flips from a generator seeded
    with theirs — a different stream from the reference's threefry, which
    the l2 decode never reads.  Any other fault model (a name or a
    ``FaultModel``, `p` its severity) corrupts the leaves in torch ops on
    the model's device, each seed an int, a ``torch.Generator`` or a draw,
    then dequantizes them (the reference's jnp route).  The one-point call
    of ``corrupt_materialize_grid``."""
    return corrupt_materialize_grid(model, [p], [seeds], scope,
                                    fault_model=fault_model)[0]


def corrupt_materialize_grid(model: HDModel, ps: Sequence[float],
                             seeds: Sequence[Sequence],
                             scope: str = "all",
                             fault_model=None) -> list:
    """``corrupt_materialize`` at G grid points: the models at (ps[g],
    seeds[g]) for g < G.  On the kernel route (``fault_model`` None or
    kernel eligible) every unprotected QTensor leaf at every point comes
    from one ``flip_corrupt_grid`` call (the reference vmaps its trial body
    over the points of a p-chunk).  Each model's corrupted leaves are views
    of the call's (G, ...) outputs; protected leaves are dequantized once
    and shared by all G models; float leaves get their per-point flips as
    in ``corrupt_materialize``, the same stream for the same seed.  Other
    fault models corrupt the points one after another."""
    from repro_torch.core.evaluate import resolve_fault_model
    fault_model = resolve_fault_model(fault_model)
    skip = fault_skip_set(scope)
    d = {k: v for k, v in model.to_dict().items() if k != "enc"}
    ps, seeds = [float(p) for p in ps], [list(row) for row in seeds]
    if len(seeds) != len(ps):
        raise ValueError(f"{len(seeds)} seed rows for {len(ps)} points")
    for row in seeds:
        if len(row) != len(d):
            raise ValueError(f"{len(row)} seeds for {len(d)} leaves {list(d)}")

    def build(out: dict) -> HDModel:
        return type(model).from_dict({**out, "enc": model.enc},
                                     **model.aux())

    if fault_model is not None and not fault_model.kernel_eligible:
        return [build(fault_model.corrupt(d, p, row, skip=skip)).materialized()
                for p, row in zip(ps, seeds)]
    if not all(isinstance(s, numbers.Integral) for row in seeds for s in row):
        raise TypeError("the flip_corrupt route takes int seeds; draws go "
                        "through HDModel.corrupted")
    leaves = list(d.values())
    flipped = [i for i, (name, leaf) in enumerate(d.items())
               if name not in skip and isinstance(leaf, QTensor)]
    outs = flip_corrupt_grid(
        [(leaves[i].codes, leaves[i].scale, leaves[i].bits) for i in flipped],
        ps, [[row[i] for i in flipped] for row in seeds])
    corrupted = dict(zip(flipped, outs))
    shared = {name: dequantize(leaf) if isinstance(leaf, QTensor) else leaf
              for name, leaf in d.items() if name in skip}
    models = []
    for g, (p, row) in enumerate(zip(ps, seeds)):
        out = {}
        for i, (name, leaf) in enumerate(d.items()):
            if i in corrupted:
                out[name] = corrupted[i][g]
            elif name in shared:
                out[name] = shared[name]
            elif leaf.is_floating_point():
                out[name] = flip_bits_f32(
                    leaf, p, GeneratorDraw.seeded(row[i], leaf.device))
            else:
                out[name] = leaf
        models.append(build(out))
    return models


# Layers above this one (``repro_torch.serving``'s bucket caches) register
# their clearers here, so that clear_cache() stays the one invalidation
# entry point without dispatch importing upward.
_EXTRA_CACHE_CLEARERS: list = []


def register_cache_clearer(fn: Callable[[], None]) -> Callable[[], None]:
    """Register a zero-argument callback that every ``clear_cache()`` runs."""
    if fn not in _EXTRA_CACHE_CLEARERS:
        _EXTRA_CACHE_CLEARERS.append(fn)
    return fn


def clear_cache() -> None:
    """Reset every registered cache in the process: the one invalidation
    entry point.  The port compiles no executables, so what it resets is
    the bookkeeping of the layers that registered (the serving layer's
    shape-bucket hit/miss counts)."""
    for fn in list(_EXTRA_CACHE_CLEARERS):
        fn()
