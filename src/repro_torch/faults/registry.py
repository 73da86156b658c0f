"""String-keyed fault-model registry (port of ``repro.faults.registry``):
``register_fault_model`` binds a name to a factory,
``make_fault_model(name, **params)`` instantiates one, and anything that
iterates ``available_fault_models()`` picks a new model up.

>>> from repro_torch.faults import make_fault_model, available_fault_models
>>> available_fault_models()
('asymmetric', 'burst', 'drift', 'iid', 'stuck_at')
>>> make_fault_model("burst", burst_rate=0.25).burst_rate
0.25
>>> make_fault_model("iid") == make_fault_model("iid")
True
"""

from __future__ import annotations

from typing import Callable

from repro_torch.faults.base import FaultModel
from repro_torch.faults.models import (AsymmetricFlip, BurstFlip, DriftFlip,
                                       IIDFlip, StuckAt)

__all__ = ["register_fault_model", "make_fault_model",
           "available_fault_models", "get_fault_model_factory"]

_REGISTRY: dict[str, Callable[..., FaultModel]] = {}


def register_fault_model(name: str,
                         factory: Callable[..., FaultModel]) -> Callable:
    """Register (or override) a fault-model factory under ``name``;
    ``factory(**params)`` returns a ``FaultModel``."""
    _REGISTRY[name] = factory
    return factory


def get_fault_model_factory(name: str) -> Callable[..., FaultModel]:
    """Look up a registered factory; KeyError lists the known names."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown fault model {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def make_fault_model(name: str, **params) -> FaultModel:
    """Instantiate a registered fault model with the given parameters."""
    return get_fault_model_factory(name)(**params)


def available_fault_models() -> tuple:
    """Sorted names of every registered fault model."""
    return tuple(sorted(_REGISTRY))


register_fault_model("iid", IIDFlip)
register_fault_model("asymmetric", AsymmetricFlip)
register_fault_model("burst", BurstFlip)
register_fault_model("stuck_at", StuckAt)
register_fault_model("drift", DriftFlip)
