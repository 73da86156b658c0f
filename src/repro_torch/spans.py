"""Named spans at the port's layer boundaries, seen in a profiler's trace.

``span(name)`` marks a stretch of host code as a layer.  While a
``torch.profiler`` session records, it is ``record_function(name)``, so the
span lands in the same Kineto trace, on the same clock, as the CUPTI
device operations: each launch, and each idle stretch of the card, can be
put down to the span its host thread was in.  Otherwise it is a shared
no-op, after one check of torch's own Python flag.  There is nothing to
configure: any profiler session turns the spans on.

The spans of a training step (every name starts with ``repro_torch.``):

  * ``repro_torch.train.forward``, ``repro_torch.train.backward``,
    ``repro_torch.train.optimizer``: the loss, its gradients (with remat's
    recomputation) and AdamW, in ``runtime/train_loop.make_train_step``;
  * ``repro_torch.attention``: ``models/attention.Attention.forward`` and
    ``models/mla.MLA.forward``;
  * ``repro_torch.mla.latent``, inside MLA's attention span: its q and kv
    compressions and norms, the rotation, the ``wkv_b`` expansion and the
    concatenation;
  * ``repro_torch.mlp``: the dense SwiGLU, ``models/layers.GatedMLP``;
  * ``repro_torch.moe.route``: ``models/moe.MoE.route`` (either router);
  * ``repro_torch.moe.experts``: the dispatch, the experts and the combine
    of ``models/moe.MoE.routed`` (or of its held share);
  * ``repro_torch.moe.shared``: the shared expert, ``MoE.shared``;
  * ``repro_torch.head``: the vocabulary head and its cross entropy in
    ``models/model.loss_fn``, once a loss chunk.

A checkpointed block opens its layer spans again when the backward
recomputes it, on the thread that runs the backward.

Counters (DeepSeek-V3's router, ``models/moe.routing_counters``): the
choices on held experts, those the capacity dropped, and each routed
expert's load, summed on the device and read once after a window.
"""

from __future__ import annotations

import contextlib

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager marking the code it wraps as span `name`."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF
