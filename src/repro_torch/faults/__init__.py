"""repro_torch.faults — the fault-model zoo (port of ``repro.faults``).

  base.py       ``FaultModel`` (a frozen dataclass) and the stored-leaf
                walker ``corrupt_tree`` shared with ``core.faults
                .flip_tree``.
  models.py     the five built-ins: ``iid`` (the ``flip_corrupt`` kernel's
                model), ``asymmetric``, ``burst``, ``stuck_at``, ``drift``.
  registry.py   ``register_fault_model`` / ``make_fault_model`` /
                ``available_fault_models``.

Every model corrupts at a scalar severity whose meaning is its own (flip
rate, row-hit rate, stuck-cell rate, read count), severity 0 being the
identity, and sweeps through ``sweep_under_flips(..., fault_model=)``.
"""

from repro_torch.faults.base import FaultModel, corrupt_tree
from repro_torch.faults.models import (AsymmetricFlip, BurstFlip, DriftFlip,
                                       IIDFlip, StuckAt)
from repro_torch.faults.registry import (available_fault_models,
                                         get_fault_model_factory,
                                         make_fault_model,
                                         register_fault_model)

__all__ = [
    "FaultModel", "corrupt_tree",
    "IIDFlip", "AsymmetricFlip", "BurstFlip", "StuckAt", "DriftFlip",
    "register_fault_model", "make_fault_model", "available_fault_models",
    "get_fault_model_factory",
]
