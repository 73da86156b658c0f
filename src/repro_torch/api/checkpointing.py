"""Checkpoints of typed models (port of ``repro.api.checkpointing``).

``save_model`` writes a model through ``checkpoint/ckpt.py`` together with
a JSON spec of its structure: its class, its aux fields and each field's
leaf metadata (array shape and dtype, QTensor shape and bits, the encoder
dict's entries).  ``load_model`` rebuilds the typed model from the spec
alone, quantized models with their bit widths.  The spec rides in the
checkpoint tree as its last scalar leaf, so a save is one atomic COMMIT.

The files are the JAX package's, leaf for leaf: a model saved here loads
with ``repro.api.checkpointing.load_model`` and the other way round.  The
JAX package runs with 32-bit integers, so integer leaves the port holds as
int64 (SparseHD's and hybrid's ``keep``) are written as int32 and read
back as int64.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.api.models import MODEL_CLASSES, HDModel
from repro_torch.checkpoint.ckpt import (LeafSpec, _step_dir, latest_step,
                                         read_scalar_leaves,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.core.quantize import QTensor
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import distributed, rank

__all__ = ["save_model", "load_model", "model_spec", "model_tree"]

# fields the port holds in another integer dtype than the files carry
_PORT_DTYPES = {"keep": torch.int64}


def _on_disk(v):
    """A leaf as the JAX package holds it: int64 tensors as int32."""
    if isinstance(v, dict):
        return {k: _on_disk(a) for k, a in v.items()}
    if isinstance(v, torch.Tensor) and v.dtype == torch.int64:
        return v.to(torch.int32)
    return v


def _leaf_spec(v) -> Optional[dict]:
    if v is None:
        return None
    if isinstance(v, QTensor):
        return {"kind": "qtensor", "shape": list(v.codes.shape),
                "bits": int(v.bits)}
    if isinstance(v, dict):
        return {"kind": "dict",
                "entries": {k: _leaf_spec(x) for k, x in v.items()}}
    return {"kind": "array", "shape": list(v.shape),
            "dtype": str(_on_disk(v).dtype).removeprefix("torch.")}


def _leaf_skeleton(spec: Optional[dict]):
    if spec is None:
        return None
    if spec["kind"] == "qtensor":
        return QTensor(LeafSpec(tuple(spec["shape"]), "int8"),
                       LeafSpec((), "float32"), spec["bits"])
    if spec["kind"] == "dict":
        return {k: _leaf_skeleton(s) for k, s in spec["entries"].items()}
    return LeafSpec(tuple(spec["shape"]), spec["dtype"])


def model_spec(model: HDModel) -> dict:
    """JSON-serializable structural description of a typed model (the JAX
    package's, key for key)."""
    fields = {f.name: _leaf_spec(getattr(model, f.name))
              for f in dataclasses.fields(model)
              if f.name not in model.aux_fields}
    return {"format": 1, "method": model.method,
            "class": type(model).__name__, "aux": model.aux(),
            "fields": fields}


def model_tree(model: HDModel) -> dict:
    """The tree ``save_model`` writes (the model's leaves as the JAX package
    holds them, and its spec); ``checkpoint.ckpt.AsyncCheckpointer`` writes
    the same files from it.  A class-sharded model gives every rank's rows
    (a collective when a process group is initialised)."""
    if hasattr(model, "full_rows"):
        model = model.full_rows()
    disk = model.replace(**{k: _on_disk(v)
                            for k, v in model.to_dict().items()})
    return {"model": disk, "spec": json.dumps(model_spec(model))}


def save_model(ckpt_dir: str, step: int, model: HDModel) -> str:
    """Atomically save a typed model (f32 or quantized).  Returns the
    committed directory path.

    A class-sharded LogHD model is written with every rank's rows (the
    padded class axis, the JAX package's layout): with a process group,
    every rank must call this, the ranks' rows are gathered, rank 0 writes
    and the others wait for its commit."""
    sharded = hasattr(model, "full_rows")
    tree = model_tree(model)
    if not (sharded and distributed()):
        return save_checkpoint(ckpt_dir, step, tree)
    path = save_checkpoint(ckpt_dir, step, tree) if rank() == 0 else None
    dist.barrier()
    return path or _step_dir(ckpt_dir, step)


def _read_spec(ckpt_dir: str, step: int) -> dict:
    # The spec is the tree's only string scalar and, "model" sorting before
    # "spec", the last one; take the last parseable candidate.
    spec = None
    for value in read_scalar_leaves(ckpt_dir, step):
        if not isinstance(value, str):
            continue
        try:
            cand = json.loads(value)
        except ValueError:
            continue
        if isinstance(cand, dict) and cand.get("format") == 1:
            spec = cand
    if spec is None:
        raise ValueError(f"no typed-model spec found in {ckpt_dir} step "
                         f"{step}; was this checkpoint written by "
                         "save_model?")
    return spec


def load_model(ckpt_dir: str, step: Optional[int] = None, *,
               device=None) -> HDModel:
    """Restore a typed model saved with ``save_model`` (by either package)
    onto `device` (None means "cuda", and raises without a card).
    ``step=None`` loads the newest committed step.  A class-sharded LogHD
    model loads at any world size: each rank keeps its own rows of the
    saved class axis."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    spec = _read_spec(ckpt_dir, step)
    cls = MODEL_CLASSES[spec["method"]]
    skeleton = cls.from_dict(
        {name: _leaf_skeleton(s) for name, s in spec["fields"].items()},
        **spec["aux"])
    model = restore_checkpoint(ckpt_dir, step,
                               {"model": skeleton, "spec": ""},
                               device=device)["model"]
    model = model.replace(**{k: getattr(model, k).to(dtype)
                             for k, dtype in _PORT_DTYPES.items()
                             if isinstance(getattr(model, k, None),
                                           torch.Tensor)})
    if hasattr(model, "full_rows"):
        from repro_torch.api.sharded import place_sharded
        model = place_sharded(model)
    return model
