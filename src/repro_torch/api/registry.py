"""String-keyed method registry and the uniform ``HDClassifier`` surface
(port of ``repro.api.registry``): "conventional", "sparsehd", "loghd" and
"hybrid".

    clf = make_classifier("loghd", 26, 617, refine_epochs=50)  # on "cuda"
    clf = clf.fit(x_train, y_train)              # bundle_update steps
    labels = clf.predict(x_test)                 # encode + kernel predict
    accs = clf.sweep_under_flips(4, [0.0, 0.1], h_test, y_test)
    burst = clf.sweep_under_flips(4, [0.0, 0.2], h_test, y_test,
                                  fault_model="burst")
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.api import _impl, dispatch
from repro_torch.api.models import (ConventionalModel, HDModel, HybridModel,
                                    LogHDModel, SparseHDModel)
from repro_torch.hdc.encoders import EncoderConfig, encode_batched
from repro_torch.kernels.common import resolve_device

__all__ = ["MethodSpec", "register_method", "get_method",
           "available_methods", "make_classifier", "HDClassifier"]


@dataclasses.dataclass(frozen=True)
class MethodSpec:
    """One registered classifier family: its model class, config factory
    ``make_config(n_classes, **kw)`` and trainer
    ``fit(cfg, enc_cfg, x, y, *, device, enc, encoded, prototypes, base,
    generator, perms)``."""
    name: str
    model_cls: type
    make_config: Callable[..., Any]
    fit: Callable[..., HDModel]


_REGISTRY: dict[str, MethodSpec] = {}


def register_method(spec: MethodSpec) -> MethodSpec:
    """Register (or override) a classifier family under ``spec.name``."""
    _REGISTRY[spec.name] = spec
    return spec


def get_method(name: str) -> MethodSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown method {name!r}; registered: "
                       f"{sorted(_REGISTRY)}") from None


def available_methods() -> tuple:
    return tuple(sorted(_REGISTRY))


@dataclasses.dataclass(frozen=True)
class HDClassifier:
    """Uniform estimator handle: config before fit, model after; immutable,
    bound to one device."""

    spec: MethodSpec
    cfg: Any
    enc_cfg: EncoderConfig
    device: torch.device
    model: Optional[HDModel] = None

    @property
    def method(self) -> str:
        return self.spec.name

    def _require_model(self) -> HDModel:
        if self.model is None:
            raise ValueError(f"{self.method} classifier is not fitted")
        return self.model

    def fit(self, x, y, *, enc: Optional[dict] = None, encoded=None,
            prototypes=None, base: Optional[HDModel] = None,
            generator: Optional[torch.Generator] = None,
            perms=None) -> "HDClassifier":
        """Train on this classifier's device.  ``generator`` draws the
        encoder's projection, ``perms`` injects the (epochs, N) example
        orders of the Eq. 9 refinement (loghd, hybrid)."""
        model = self.spec.fit(self.cfg, self.enc_cfg, x, y,
                              device=self.device, enc=enc, encoded=encoded,
                              prototypes=prototypes, base=base,
                              generator=generator, perms=perms)
        return dataclasses.replace(self, model=model)

    def with_model(self, model: HDModel) -> "HDClassifier":
        return dataclasses.replace(self, model=model)

    def encode(self, x) -> torch.Tensor:
        return encode_batched(self._require_model().enc, x, self.enc_cfg.kind)

    def predict(self, x) -> torch.Tensor:
        return self.predict_encoded(self.encode(x))

    def predict_encoded(self, h) -> torch.Tensor:
        """Batched predict, through the kernels on the card."""
        return dispatch.predict_encoded(self._require_model(),
                                        torch.as_tensor(h, device=self.device))

    def accuracy(self, h, y) -> float:
        labels = self.predict_encoded(h)
        y = torch.as_tensor(y, device=labels.device)
        return float((labels == y).float().mean())

    def quantized(self, bits: int) -> "HDClassifier":
        return self.with_model(self._require_model().quantized(bits))

    def corrupted(self, p: float, seeds, scope: str = "all",
                  fault_model=None) -> "HDClassifier":
        """``HDModel.corrupted``: one seed per stored leaf."""
        return self.with_model(self._require_model().corrupted(
            p, seeds, scope, fault_model=fault_model))

    def materialized(self) -> "HDClassifier":
        return self.with_model(self._require_model().materialized())

    def sweep_under_flips(self, bits: int, p_grid, h_test, y_test, *,
                          fault_model=None, **kw):
        """(|p_grid|, n_trials) accuracy matrix; keywords as
        ``repro_torch.core.evaluate.sweep_under_flips``.  ``fault_model``
        names a registered ``repro_torch.faults`` model (or passes an
        instance); ``p_grid`` is then its severity grid."""
        return self._require_model().sweep_under_flips(
            bits, p_grid, h_test, y_test, fault_model=fault_model, **kw)

    def model_bits(self, bits: int) -> int:
        return self._require_model().model_bits(bits)


def make_classifier(name: str, n_classes: int,
                    in_features: Optional[int] = None, *,
                    enc_cfg: Optional[EncoderConfig] = None,
                    dim: int = 10_000, encoder_kind: str = "cos",
                    device=None, **method_kw) -> HDClassifier:
    """Construct an unfitted classifier for a registered method.

    ``device=None`` means "cuda", and raises when no CUDA device is
    available; pass ``device="cpu"`` to run the plain versions on the CPU.
    ``method_kw`` goes to the family's config (e.g. ``k=2,
    extra_bundles=5, refine_epochs=50`` for loghd, ``sparsity=0.6`` for
    sparsehd).  ``class_sharding=S`` (and ``data_sharding=Dp``) on loghd
    fits the class-sharded ``ShardedLogHDModel`` (``api/sharded.py``)."""
    device = resolve_device(device)
    spec = get_method(name)
    if enc_cfg is None:
        if in_features is None:
            raise ValueError("make_classifier needs in_features or enc_cfg")
        enc_cfg = EncoderConfig(in_features, dim, encoder_kind)
    return HDClassifier(spec=spec, cfg=spec.make_config(n_classes, **method_kw),
                        enc_cfg=enc_cfg, device=device)


def _conventional_config(n_classes: int, **kw):
    from repro_torch.hdc.conventional import ConventionalConfig
    return ConventionalConfig(n_classes=n_classes, **kw)


def _sparsehd_config(n_classes: int, **kw):
    from repro_torch.core.sparsehd import SparseHDConfig
    return SparseHDConfig(n_classes=n_classes, **kw)


def _loghd_config(n_classes: int, **kw):
    from repro_torch.core.loghd import LogHDConfig
    return LogHDConfig(n_classes=n_classes, **kw)


def _hybrid_config(n_classes: int, *, sparsity: float = 0.5,
                   saliency: str = "spread", loghd=None, **loghd_kw):
    from repro_torch.core.hybrid import HybridConfig
    from repro_torch.core.loghd import LogHDConfig
    if loghd is not None and loghd_kw:
        raise ValueError(
            f"pass either a full loghd config or loghd kwargs, not both "
            f"(got loghd=... and {sorted(loghd_kw)})")
    lcfg = loghd if loghd is not None else LogHDConfig(n_classes=n_classes,
                                                      **loghd_kw)
    return HybridConfig(loghd=lcfg, sparsity=sparsity, saliency=saliency)


register_method(MethodSpec("conventional", ConventionalModel,
                           _conventional_config,
                           _impl.fit_conventional_model))
register_method(MethodSpec("sparsehd", SparseHDModel, _sparsehd_config,
                           _impl.fit_sparsehd_model))
register_method(MethodSpec("loghd", LogHDModel, _loghd_config,
                           _impl.fit_loghd_model))
register_method(MethodSpec("hybrid", HybridModel, _hybrid_config,
                           _impl.fit_hybrid_model))
