"""Typed model classes for the four classifier families (port of
``repro.api.models``).

A model is a frozen dataclass of tensors.  It declares the ``stored_leaves``
that count against the memory budget and receive bit flips, its
``model_bits`` accounting and a plain-torch ``predict_encoded``, and it
supports the robustness pipeline ``quantized(bits)`` ->
``corrupted_materialized(p, seeds)`` -> predict (or, for a sweep's chunk of
points, ``corrupted_materialized_grid(ps, seeds)``), each taking a
``fault_model=`` of ``repro_torch.faults``; ``corrupted(p, seeds)`` keeps
the corrupted codes quantized.

``to_dict``/``from_dict`` flatten a model to its field dict; the order of
that dict (the reference's field order, e.g. LogHD's bundles, profiles,
codebook, sigma_inv) is the order in which a corruption takes one seed per
leaf, protected leaves (``keep``, ``codebook``) included.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar, Sequence

import torch

from repro_torch.core.profiles import activations, decode_profiles
from repro_torch.core.quantize import QTensor, dequantize, quantize
from repro_torch.hdc.conventional import l2_normalize, predict_from_encoded
from repro_torch.precision import full_f32

__all__ = ["HDModel", "ConventionalModel", "SparseHDModel", "LogHDModel",
           "HybridModel", "MODEL_CLASSES"]


def _shape(leaf) -> tuple:
    """Shape of a tensor or QTensor leaf (QTensor stores codes)."""
    return tuple(leaf.codes.shape if isinstance(leaf, QTensor) else leaf.shape)


class HDModel:
    """Shared behaviour of the typed classifier models.

    Subclasses are frozen dataclasses; ``aux_fields`` names the static
    configuration fields (not arrays)."""

    method: ClassVar[str]
    stored_leaves: ClassVar[tuple]
    aux_fields: ClassVar[tuple] = ()
    # False for subclasses whose predict math the kernels do not implement
    kernel_dispatch: ClassVar[bool] = True

    def to_dict(self) -> dict:
        """Field dict without the aux fields and without None fields."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if f.name not in self.aux_fields
                and getattr(self, f.name) is not None}

    @classmethod
    def from_dict(cls, d: dict, **aux) -> "HDModel":
        kw = {f.name: d.get(f.name) for f in dataclasses.fields(cls)
              if f.name not in cls.aux_fields}
        kw.update(aux)
        return cls(**kw)

    def aux(self) -> dict:
        return {n: getattr(self, n) for n in self.aux_fields}

    def replace(self, **updates) -> "HDModel":
        return dataclasses.replace(self, **updates)

    def to(self, device) -> "HDModel":
        """The model with every tensor leaf (encoder, QTensor codes and
        scales included) on `device`."""
        def move(v):
            if isinstance(v, QTensor):
                return QTensor(v.codes.to(device), v.scale.to(device), v.bits)
            if isinstance(v, dict):
                return {k: move(a) for k, a in v.items()}
            return v.to(device)
        return self.replace(**{k: move(v) for k, v in self.to_dict().items()})

    # ------------------------------------------- robustness pipeline ------
    def quantized(self, bits: int) -> "HDModel":
        """Post-training quantize the stored leaves to `bits`-bit codes."""
        return self.replace(**{name: quantize(getattr(self, name), bits)
                               for name in self.stored_leaves})

    def materialized(self) -> "HDModel":
        """Dequantize any QTensor leaves back to f32 for inference."""
        updates = {name: dequantize(getattr(self, name))
                   for name in self.stored_leaves
                   if isinstance(getattr(self, name), QTensor)}
        return self.replace(**updates) if updates else self

    def corrupted(self, p: float, seeds: Sequence, scope: str = "all",
                  fault_model=None) -> "HDModel":
        """The model with bits of its stored int codes and float leaves
        corrupted, still quantized.  ``seeds`` holds one seed per
        ``to_dict()`` leaf without ``enc`` (an int, a ``torch.Generator``
        or a draw, ``core.faults.as_draw``).  ``fault_model=None`` is iid
        flips at rate `p` (``core.faults.corrupt_model``), a registered name
        or ``FaultModel`` that model at severity `p`; every draw comes from
        torch generators on the model's device, not from the
        ``flip_corrupt`` counter hash of ``corrupted_materialized``."""
        from repro_torch.core.evaluate import resolve_fault_model
        from repro_torch.core.faults import corrupt_model, fault_skip_set
        fault_model = resolve_fault_model(fault_model)
        d = self.to_dict()
        if fault_model is None:
            out = corrupt_model(d, p, seeds, scope)
        else:
            out = fault_model.corrupt(
                {k: v for k, v in d.items() if k != "enc"}, p, seeds,
                skip=fault_skip_set(scope))
            out["enc"] = self.enc
        return type(self).from_dict(out, **self.aux())

    def corrupted_materialized(self, p: float, seeds: Sequence,
                               scope: str = "all",
                               fault_model=None) -> "HDModel":
        """Corrupt + dequantize in one step — the fault-sweep trial body:
        the ``flip_corrupt`` kernel on the card, its plain version on the
        CPU, for the default and ``"iid"``; another ``fault_model`` runs in
        torch ops on the model's device (``dispatch.corrupt_materialize``).
        ``seeds`` holds one seed per ``to_dict()`` leaf."""
        from repro_torch.api.dispatch import corrupt_materialize
        return corrupt_materialize(self, p, seeds, scope,
                                   fault_model=fault_model)

    def corrupted_materialized_grid(self, ps: Sequence[float],
                                    seeds: Sequence[Sequence],
                                    scope: str = "all",
                                    fault_model=None) -> list:
        """``corrupted_materialized`` at G points (ps[g], seeds[g]): one
        ``flip_corrupt`` launch for all of them on the kernel route, the
        sweep's chunk."""
        from repro_torch.api.dispatch import corrupt_materialize_grid
        return corrupt_materialize_grid(self, ps, seeds, scope,
                                        fault_model=fault_model)

    def sweep_under_flips(self, bits: int, p_grid, h_test, y_test, **kw):
        """(|p_grid|, n_trials) accuracy matrix; see
        ``repro_torch.core.evaluate.sweep_under_flips`` (``fault_model=``
        reads ``p_grid`` as that model's severity grid)."""
        from repro_torch.core.evaluate import sweep_under_flips
        return sweep_under_flips(self, bits, p_grid, h_test, y_test, **kw)

    # --------------------------------------------------------- interface --
    def predict_encoded(self, h: torch.Tensor) -> torch.Tensor:
        """Labels for pre-encoded queries: (B, D) -> (B,) int64."""
        raise NotImplementedError

    @full_f32()
    def predict(self, x) -> torch.Tensor:
        """Encode raw features with the model's own encoder, then predict."""
        from repro_torch.hdc.encoders import encode_batched
        return self.predict_encoded(encode_batched(self.enc, x,
                                                   self.encoder_kind))

    def model_bits(self, bits: int) -> int:
        raise NotImplementedError

    def stored_bytes(self) -> int:
        """Bytes of the stored leaves as held now: f32 arrays at 4 bytes a
        word, QTensor leaves at their int8 codes plus the f32 scale."""
        total = 0
        for name in self.stored_leaves:
            v = getattr(self, name)
            if isinstance(v, QTensor):
                total += v.codes.numel() * v.codes.element_size() + 4
            else:
                total += v.numel() * v.element_size()
        return total


@dataclasses.dataclass(frozen=True, eq=False)
class ConventionalModel(HDModel):
    """One prototype per class (the paper's uncompressed baseline)."""

    enc: dict
    protos: Any                       # (C, D) f32 or QTensor
    encoder_kind: str = "cos"

    method: ClassVar[str] = "conventional"
    stored_leaves: ClassVar[tuple] = ("protos",)
    aux_fields: ClassVar[tuple] = ("encoder_kind",)

    def predict_encoded(self, h: torch.Tensor) -> torch.Tensor:
        """argmax_c cosine(h, H_c)."""
        return predict_from_encoded(self.protos, h)

    def model_bits(self, bits: int) -> int:
        """C * D * bits — the uncompressed budget every fraction divides by."""
        c, d = _shape(self.protos)
        return c * d * bits

    @property
    def n_classes(self) -> int:
        return _shape(self.protos)[0]


@dataclasses.dataclass(frozen=True, eq=False)
class SparseHDModel(HDModel):
    """Feature-axis baseline: pruned prototypes + shared keep-mask."""

    enc: dict
    protos: Any                       # (C, D') f32 or QTensor
    keep: Any                         # (D',) int64 retained dim indices
    encoder_kind: str = "cos"

    method: ClassVar[str] = "sparsehd"
    stored_leaves: ClassVar[tuple] = ("protos",)
    aux_fields: ClassVar[tuple] = ("encoder_kind",)

    def predict_encoded(self, h: torch.Tensor) -> torch.Tensor:
        """Slice queries to the kept dimensions, then nearest prototype."""
        return predict_from_encoded(self.protos, l2_normalize(h[:, self.keep]))

    def model_bits(self, bits: int) -> int:
        """C * D' * bits for the kept values + D bits for the shared mask."""
        c, d_kept = _shape(self.protos)
        return c * d_kept * bits + self.enc["proj"].shape[1]

    @property
    def n_classes(self) -> int:
        return _shape(self.protos)[0]


@dataclasses.dataclass(frozen=True, eq=False)
class LogHDModel(HDModel):
    """The paper's class-axis compressor: n bundles + C activation profiles."""

    enc: dict
    bundles: Any                      # (n, D) f32 or QTensor
    profiles: Any                     # (C, n) f32 or QTensor
    codebook: Any                     # (C, n) int32 — structural, protected
    sigma_inv: Any = None             # (n, n) for the Mahalanobis variant
    metric: str = "l2"
    encoder_kind: str = "cos"

    method: ClassVar[str] = "loghd"
    stored_leaves: ClassVar[tuple] = ("bundles", "profiles")
    aux_fields: ClassVar[tuple] = ("metric", "encoder_kind")

    def predict_encoded(self, h: torch.Tensor) -> torch.Tensor:
        """Profile decode (Eq. 5-7) in plain torch: A(x) = h M^T, then the
        nearest per-class profile under ``self.metric``."""
        acts = activations(self.bundles, h)
        return decode_profiles(self.profiles, acts, self.metric,
                               sigma_inv=self.sigma_inv)

    def model_bits(self, bits: int) -> int:
        """n*D*bits bundles + C*n*bits profiles (both are flip-injected)."""
        from repro_torch.core.loghd import memory_bits
        n, d = _shape(self.bundles)
        c, _ = _shape(self.profiles)
        return memory_bits(c, d, n, bits)

    @property
    def n_classes(self) -> int:
        return _shape(self.profiles)[0]

    @property
    def n_bundles(self) -> int:
        return _shape(self.bundles)[0]


@dataclasses.dataclass(frozen=True, eq=False)
class HybridModel(HDModel):
    """Class-axis + feature-axis: sparsified bundles + re-estimated profiles."""

    enc: dict
    bundles: Any                      # (n, D') f32 or QTensor
    profiles: Any                     # (C, n) f32 or QTensor
    keep: Any                         # (D',) int64
    codebook: Any                     # (C, n) int32
    metric: str = "l2"
    encoder_kind: str = "cos"

    method: ClassVar[str] = "hybrid"
    stored_leaves: ClassVar[tuple] = ("bundles", "profiles")
    aux_fields: ClassVar[tuple] = ("metric", "encoder_kind")

    def predict_encoded(self, h: torch.Tensor) -> torch.Tensor:
        """Slice to the kept dimensions, renormalize, then profile-decode."""
        acts = activations(self.bundles, l2_normalize(h[:, self.keep]))
        return decode_profiles(self.profiles, acts, self.metric)

    def model_bits(self, bits: int) -> int:
        """n*(1-S)*D + C*n value words at ``bits`` + D shared mask bits."""
        n, d_kept = _shape(self.bundles)
        c, _ = _shape(self.profiles)
        return n * d_kept * bits + c * n * bits + self.enc["proj"].shape[1]

    @property
    def n_classes(self) -> int:
        return _shape(self.profiles)[0]

    @property
    def n_bundles(self) -> int:
        return _shape(self.bundles)[0]


MODEL_CLASSES = {cls.method: cls for cls in
                 (ConventionalModel, SparseHDModel, LogHDModel, HybridModel)}
