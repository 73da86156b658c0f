"""Fit implementation behind the method registry (port of
``repro.api._impl``; LogHD so far).

    fit(cfg, enc_cfg, x, y, *, device, enc=None, encoded=None,
        prototypes=None, generator=None) -> HDModel

``enc`` + ``encoded`` (and ``prototypes``) share work across methods, as in
the JAX package; ``generator`` draws the encoder's projection when it is
fitted here.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.api.models import LogHDModel
from repro_torch.core import codebook as cb
from repro_torch.core.bundling import build_bundles
from repro_torch.core.loghd import LogHDConfig
from repro_torch.core.profiles import estimate_profiles
from repro_torch.hdc.conventional import class_prototypes
from repro_torch.hdc.encoders import EncoderConfig, fit_encoder

__all__ = ["fit_loghd_model"]


def fit_loghd_model(cfg: LogHDConfig, enc_cfg: EncoderConfig, x, y, *,
                    device, enc: Optional[dict] = None,
                    encoded: Optional[torch.Tensor] = None,
                    prototypes: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None
                    ) -> LogHDModel:
    """Train a LogHD model (paper Algorithm 1) without Eq. 9 refinement.

    Prototypes -> capacity-aware codebook (greedy tie-breaks from a CPU
    generator seeded with ``cfg.seed``) -> bundle superposition ->
    activation-profile estimation, plus ``sigma_inv`` (the inverse pooled
    within-class activation covariance) for the Mahalanobis decode."""
    if cfg.refine_epochs > 0:
        raise NotImplementedError(
            f"refine_epochs={cfg.refine_epochs}: Eq. 9 refinement comes with "
            f"the training slice of the port (bundle_update); pass "
            f"refine_epochs=0")
    if cfg.class_sharding > 1 or cfg.data_sharding > 1:
        raise NotImplementedError(
            "class_sharding / data_sharding > 1: the sharded LogHD estimator "
            "is not ported yet")
    device = torch.device(device)
    if enc is None or encoded is None:
        enc, h = fit_encoder(enc_cfg, x, device=device, generator=generator)
    else:
        h = torch.as_tensor(encoded, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, device=device).to(torch.int64)
    protos = (class_prototypes(h, y, cfg.n_classes) if prototypes is None
              else torch.as_tensor(prototypes, device=device))

    book = torch.as_tensor(
        cb.build_codebook(cfg.n_classes, cfg.n_bundles, cfg.k,
                          alpha=cfg.alpha, seed=cfg.seed,
                          method=cfg.codebook_method), device=device)
    bundles = build_bundles(protos, book, cfg.k, bipolar=cfg.bipolar_init)
    profiles = estimate_profiles(bundles, h, y, cfg.n_classes)

    acts = h @ bundles.T
    resid = acts - profiles[y]
    sigma = (resid.T @ resid / resid.shape[0]
             + 1e-6 * torch.eye(cfg.n_bundles, device=device))
    return LogHDModel(enc=enc, bundles=bundles, profiles=profiles,
                      codebook=book, sigma_inv=torch.linalg.inv(sigma),
                      metric=cfg.metric, encoder_kind=enc_cfg.kind)
