"""Carry a model's weights between the JAX package and the port (all four
families).

The exchange format is plain numpy: the reference model's field dict,
``{k: np.asarray(v) for k, v in model.to_dict().items()}``, with the
encoder as a dict of arrays and each ``QTensor`` leaf as a
``(codes, scale, bits)`` tuple.  Neither direction imports JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.api.models import MODEL_CLASSES, HDModel, LogHDModel
from repro_torch.core.quantize import QTensor


def _to_torch(v, device):
    if isinstance(v, tuple):
        codes, scale, bits = v
        return QTensor(torch.from_numpy(np.array(codes)).to(device),
                       torch.from_numpy(np.array(scale, np.float32)).to(device),
                       int(bits))
    if isinstance(v, dict):
        return {k: _to_torch(a, device) for k, a in v.items()}
    return torch.from_numpy(np.array(v)).to(device)


def _to_numpy(v):
    if isinstance(v, QTensor):
        return (v.codes.cpu().numpy(), v.scale.cpu().numpy(), v.bits)
    if isinstance(v, dict):
        return {k: _to_numpy(a) for k, a in v.items()}
    return v.cpu().numpy()


def model_class(fields) -> type:
    """The family whose fields these are: every field without a default is
    present and none is foreign (LogHD's optional ``sigma_inv`` may be
    missing; ``keep`` tells SparseHD from conventional, hybrid from
    LogHD)."""
    fields = set(fields)
    for cls in MODEL_CLASSES.values():
        names = {f.name for f in dataclasses.fields(cls)} - set(cls.aux_fields)
        required = {f.name for f in dataclasses.fields(cls)
                    if f.name in names and f.default is dataclasses.MISSING}
        if required <= fields <= names:
            return cls
    raise ValueError(f"no model family has the fields {sorted(fields)}")


def from_reference(arrays: dict, *, device, metric: str = "l2",
                   encoder_kind: str = "cos",
                   class_sharding: Optional[int] = None,
                   n_classes_real: int = 0) -> HDModel:
    """The port's model on `device` from a reference model's numpy field
    dict; the family is read from the field set.  `metric` applies to the
    families that decode profiles.  ``class_sharding`` (with
    ``n_classes_real``, the aux fields of the reference's
    ``ShardedLogHDModel``) makes a class-sharded LogHD model from the
    reference's padded rows, of which this rank keeps its own."""
    device = torch.device(device)
    cls = model_class(arrays)
    aux = {"metric": metric, "encoder_kind": encoder_kind}
    if class_sharding is not None:
        from repro_torch.api.sharded import ShardedLogHDModel, place_sharded
        if cls is not LogHDModel:
            raise ValueError(f"class_sharding applies to LogHD, not "
                             f"{cls.__name__}")
        model = ShardedLogHDModel.from_dict(
            {k: _to_torch(v, device) for k, v in arrays.items()}, **aux,
            class_sharding=int(class_sharding),
            n_classes_real=int(n_classes_real))
        return place_sharded(model)
    return cls.from_dict({k: _to_torch(v, device) for k, v in arrays.items()},
                         **{k: aux[k] for k in cls.aux_fields})


def to_reference(model: HDModel) -> dict:
    """The inverse: the model's field dict as numpy arrays (QTensor leaves
    as ``(codes, scale, bits)``); a class-sharded model gives every rank's
    rows, padded as the reference holds them."""
    if hasattr(model, "full_rows"):
        model = model.full_rows()
    return {k: _to_numpy(v) for k, v in model.to_dict().items()}
