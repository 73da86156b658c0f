"""Carry a LogHD model's weights between the JAX package and the port.

The exchange format is plain numpy: the reference model's field dict,
``{k: np.asarray(v) for k, v in model.to_dict().items()}``, with the
encoder as a dict of arrays and each ``QTensor`` leaf as a
``(codes, scale, bits)`` tuple.  Neither direction imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.api.models import LogHDModel
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


def from_reference(arrays: dict, *, device, metric: str = "l2",
                   encoder_kind: str = "cos") -> LogHDModel:
    """The port's ``LogHDModel`` on `device` from a reference model's numpy
    field dict."""
    device = torch.device(device)
    return LogHDModel.from_dict({k: _to_torch(v, device)
                                 for k, v in arrays.items()},
                                metric=metric, encoder_kind=encoder_kind)


def to_reference(model: LogHDModel) -> dict:
    """The inverse: the model's field dict as numpy arrays (QTensor leaves
    as ``(codes, scale, bits)``)."""
    return {k: _to_numpy(v) for k, v in model.to_dict().items()}
