"""Fit implementations behind the method registry (port of
``repro.api._impl``), one ``fit_*_model`` per classifier family.

    fit(cfg, enc_cfg, x, y, *, device, enc=None, encoded=None,
        prototypes=None, base=None, generator=None, perms=None) -> HDModel

``enc`` + ``encoded`` (and ``prototypes``) share work across methods, as in
the JAX package, and the hybrid trainer reuses a fitted LogHD ``base``;
``generator`` draws the encoder's projection when it is fitted here;
``perms`` injects the (epochs, N) example orders of the Eq. 9 refinement
(default: a CPU generator seeded with ``cfg.seed``).  Refinement and
retraining run on ``fit_engine``, whose minibatch steps go through the
``bundle_update`` kernel on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.fit_engine import fused_onlinehd_fit, fused_refine_bundles
from repro_torch.api.models import (ConventionalModel, HybridModel, LogHDModel,
                                    SparseHDModel)
from repro_torch.core import codebook as cb
from repro_torch.core.bundling import build_bundles
from repro_torch.core.hybrid import HybridConfig
from repro_torch.core.loghd import LogHDConfig
from repro_torch.core.profiles import estimate_profiles
from repro_torch.core.sparsehd import SparseHDConfig, keep_indices
from repro_torch.hdc.conventional import (ConventionalConfig,
                                          class_prototypes, l2_normalize)
from repro_torch.hdc.encoders import EncoderConfig, encode_batched, fit_encoder
from repro_torch.precision import full_f32

__all__ = ["fit_conventional_model", "fit_sparsehd_model", "fit_loghd_model",
           "fit_hybrid_model"]


def _encoder_and_encodings(enc_cfg: EncoderConfig, x, device, enc, encoded,
                           generator):
    """Fit the shared encoder unless the caller supplies one + encodings."""
    if enc is None or encoded is None:
        return fit_encoder(enc_cfg, x, device=device, generator=generator)
    return enc, torch.as_tensor(encoded, dtype=torch.float32, device=device)


def _labels(y, device) -> torch.Tensor:
    return torch.as_tensor(y, device=device).to(torch.int64)


@full_f32()
def fit_conventional_model(cfg: ConventionalConfig, enc_cfg: EncoderConfig,
                           x, y, *, device, enc: Optional[dict] = None,
                           encoded=None, prototypes=None, base=None,
                           generator: Optional[torch.Generator] = None,
                           perms=None) -> ConventionalModel:
    """Superpose per-class prototypes, optionally OnlineHD-refine them.

    With ``prototypes`` + ``enc`` and no refinement the model is assembled
    directly (the shared-prototype path of the benchmark fixtures)."""
    device = torch.device(device)
    if prototypes is not None and enc is not None and cfg.refine_epochs == 0:
        return ConventionalModel(enc=enc, protos=torch.as_tensor(
            prototypes, device=device), encoder_kind=enc_cfg.kind)
    enc, h = _encoder_and_encodings(enc_cfg, x, device, enc, encoded,
                                    generator)
    y = _labels(y, device)
    protos = fused_onlinehd_fit(class_prototypes(h, y, cfg.n_classes), h, y,
                                lr=cfg.lr, batch_size=cfg.batch_size,
                                epochs=cfg.refine_epochs)
    return ConventionalModel(enc=enc, protos=protos, encoder_kind=enc_cfg.kind)


@full_f32()
def fit_sparsehd_model(cfg: SparseHDConfig, enc_cfg: EncoderConfig, x, y, *,
                       device, enc: Optional[dict] = None, encoded=None,
                       prototypes=None, base=None,
                       generator: Optional[torch.Generator] = None,
                       perms=None) -> SparseHDModel:
    """Prune the least-salient dimensions, then OnlineHD-retrain in the
    kept space."""
    device = torch.device(device)
    enc, h = _encoder_and_encodings(enc_cfg, x, device, enc, encoded,
                                    generator)
    y = _labels(y, device)
    protos = (class_prototypes(h, y, cfg.n_classes) if prototypes is None
              else torch.as_tensor(prototypes, device=device))
    keep = keep_indices(protos, cfg.sparsity, cfg.saliency)
    protos_s = fused_onlinehd_fit(l2_normalize(protos[:, keep]),
                                  l2_normalize(h[:, keep]), y, lr=cfg.lr,
                                  batch_size=cfg.batch_size,
                                  epochs=cfg.retrain_epochs)
    return SparseHDModel(enc=enc, protos=protos_s, keep=keep,
                         encoder_kind=enc_cfg.kind)


@full_f32()
def fit_loghd_model(cfg: LogHDConfig, enc_cfg: EncoderConfig, x, y, *,
                    device, enc: Optional[dict] = None, encoded=None,
                    prototypes=None, base=None,
                    generator: Optional[torch.Generator] = None,
                    perms=None) -> LogHDModel:
    """Train a LogHD model (paper Algorithm 1).

    Prototypes -> capacity-aware codebook (greedy tie-breaks from a CPU
    generator seeded with ``cfg.seed``) -> bundle superposition -> Eq. 9
    refinement -> activation-profile estimation, plus ``sigma_inv`` (the
    inverse pooled within-class activation covariance) for the Mahalanobis
    decode.

    ``cfg.class_sharding > 1`` (or ``data_sharding > 1``) hands the whole
    fit to the class-sharded estimator, ``repro_torch.api.sharded``, which
    returns a ``ShardedLogHDModel``."""
    if cfg.class_sharding > 1 or cfg.data_sharding > 1:
        from repro_torch.api.sharded import fit_loghd_sharded
        return fit_loghd_sharded(cfg, enc_cfg, x, y, device=device, enc=enc,
                                 encoded=encoded, prototypes=prototypes,
                                 base=base, generator=generator, perms=perms)
    device = torch.device(device)
    enc, h = _encoder_and_encodings(enc_cfg, x, device, enc, encoded,
                                    generator)
    y = _labels(y, device)
    protos = (class_prototypes(h, y, cfg.n_classes) if prototypes is None
              else torch.as_tensor(prototypes, device=device))

    book = torch.as_tensor(
        cb.build_codebook(cfg.n_classes, cfg.n_bundles, cfg.k,
                          alpha=cfg.alpha, seed=cfg.seed,
                          method=cfg.codebook_method), device=device)
    bundles = build_bundles(protos, book, cfg.k, bipolar=cfg.bipolar_init)
    bundles = fused_refine_bundles(bundles, h, y, book, cfg.k,
                                   epochs=cfg.refine_epochs, lr=cfg.lr,
                                   batch_size=cfg.refine_batch,
                                   seed=cfg.seed, perms=perms)
    profiles = estimate_profiles(bundles, h, y, cfg.n_classes)

    acts = h @ bundles.T
    resid = acts - profiles[y]
    sigma = (resid.T @ resid / resid.shape[0]
             + 1e-6 * torch.eye(cfg.n_bundles, device=device))
    return LogHDModel(enc=enc, bundles=bundles, profiles=profiles,
                      codebook=book, sigma_inv=torch.linalg.inv(sigma),
                      metric=cfg.metric, encoder_kind=enc_cfg.kind)


@full_f32()
def fit_hybrid_model(cfg: HybridConfig, enc_cfg: EncoderConfig, x, y, *,
                     device, enc: Optional[dict] = None, encoded=None,
                     prototypes=None, base: Optional[LogHDModel] = None,
                     generator: Optional[torch.Generator] = None,
                     perms=None) -> HybridModel:
    """Sparsify a LogHD base model's bundles, re-estimate its profiles.

    ``base`` (a fitted ``LogHDModel``) skips training LogHD; otherwise one
    is fitted from ``cfg.loghd`` first (``perms`` go to its refinement)."""
    device = torch.device(device)
    if base is None:
        base = fit_loghd_model(cfg.loghd, enc_cfg, x, y, device=device,
                               enc=enc, encoded=encoded,
                               prototypes=prototypes, generator=generator,
                               perms=perms)
    h = (encode_batched(base.enc, x, enc_cfg.kind) if encoded is None
         else torch.as_tensor(encoded, dtype=torch.float32, device=device))
    keep = keep_indices(base.bundles, cfg.sparsity, cfg.saliency)
    bundles_s = l2_normalize(base.bundles[:, keep])
    profiles = estimate_profiles(bundles_s, l2_normalize(h[:, keep]),
                                 _labels(y, device), cfg.loghd.n_classes)
    return HybridModel(enc=base.enc, bundles=bundles_s, profiles=profiles,
                       keep=keep, codebook=base.codebook,
                       metric=cfg.loghd.metric, encoder_kind=enc_cfg.kind)
