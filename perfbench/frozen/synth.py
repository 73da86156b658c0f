"""Synthetic surrogates for the paper's UCI datasets (numpy only).

A frozen copy of ``repro_torch/data/synth.py`` (itself a copy of the JAX
package's): ``load_dataset`` returns arrays byte-identical to the program's
for the same name and seed.  ``load_pool`` adds the benchmark's own draw:
the training split and several test-sized batches from one generator.

ISOLET / UCIHAR / PAMAP2 / PAGE are not downloaded.  We generate
class-conditional data with *identical* (#features, #classes, #train, #test) and geometry calibrated to the two
observable statistics that drive every experiment in the paper:

  1. conventional-HDC clean accuracy lands in the paper's regime (~0.90-0.95)
  2. own-class encoded similarity is high and tight (rho ~ 0.8 +- 0.13),
     which is what real, well-clustered UCI sensor data exhibits and what
     LogHD's activation-profile decoding depends on.

Generator: classes are well-separated low-dimensional clusters (signal-
dominated; ambient noise has total norm ~nu << class separation), with
within-class multi-modal structure, plus an *ambiguous fraction* of samples
blended between two class means.  The ambiguous samples cap achievable
accuracy for every method equally — mirroring how real datasets' errors
concentrate on genuinely confusable examples (e.g. ISOLET's B/D/E letters) —
while the clean majority remains crisply decodable.  Calibration was
validated empirically: conventional = 0.92 / LogHD(k=2, n=6) = 0.90 on the
isolet surrogate, matching the paper's "competitive, trails slightly" gap.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SynthSpec:
    name: str
    n_features: int
    n_classes: int
    n_train: int
    n_test: int
    sep: float = 2.0            # class-mean separation (vs nu ambient noise)
    ambiguous: float = 0.40     # fraction of samples blended toward a 2nd class
    lam_max: float = 0.65       # blend strength ~ U(0, lam_max): a CONTINUOUS
                                # margin distribution, so accuracy degrades
                                # smoothly under perturbations (like real data)
                                # instead of holding flat then collapsing
    nu: float = 1.0             # total ambient noise norm (per-feature nu/sqrt(F))
    modes_per_class: int = 3
    mode_scale: float = 0.3     # within-class mode spread as a fraction of sep
    n_groups: int = 0           # confusable-class groups (ISOLET's E-set
                                # letters, HAR's walking variants): classes in
                                # a group share a direction; within-group
                                # margins are tight and degrade first under
                                # noise.  0 = independent classes.
    within_group: float = 0.45  # within-group separation as fraction of sep
    seed: int = 1234


# Matched to Table I of the paper; `ambiguous` calibrated per dataset so
# conventional-HDC clean accuracy lands in the paper's regime at D = 10k.
DATASETS = {
    "isolet": SynthSpec("isolet", 617, 26, 6238, 1559, ambiguous=0.15),
    "ucihar": SynthSpec("ucihar", 561, 12, 6213, 1554, ambiguous=0.10),
    # PAMAP2 full size is 611k/101k; cap via load_dataset(max_train=...)
    "pamap2": SynthSpec("pamap2", 75, 5, 611142, 101582, ambiguous=0.12),
    "page":   SynthSpec("page", 10, 5, 4925, 548, ambiguous=0.10),
}
# Note: the paper's Table I lists UCIHAR with 261 features; the original UCI
# release has 561.  We follow the original count — the choice only scales the
# (shared, uncounted) encoder.


def _make_split(spec: SynthSpec, n: int, rng: np.random.Generator,
                means: np.ndarray):
    c, modes, f = means.shape
    y = rng.integers(0, c, size=n)
    mode = rng.integers(0, modes, size=n)
    mu = means[y, mode]                                    # (n, F)
    # ambiguous samples: blend toward a second class's mean with continuous
    # strength lam ~ U(0, lam_max); lam > 0.5 samples are Bayes errors, lam
    # near 0.5 samples have near-zero margin and flip under small noise
    is_amb = rng.random(n) < spec.ambiguous
    y2 = (y + rng.integers(1, c, size=n)) % c
    lam = rng.uniform(0.0, spec.lam_max, size=n)[:, None]
    mu = np.where(is_amb[:, None], (1 - lam) * mu + lam * means[y2, mode], mu)
    x = mu + rng.standard_normal((n, f)) * (spec.nu / np.sqrt(f))
    return x.astype(np.float32), y.astype(np.int32)


def load_dataset(name: str, *, max_train: int | None = None,
                 max_test: int | None = None, seed: int | None = None):
    """Returns (x_train, y_train, x_test, y_test, spec)."""
    spec = DATASETS[name]
    rng = np.random.default_rng(seed if seed is not None else spec.seed)

    class_dir = rng.standard_normal((spec.n_classes, spec.n_features))
    class_dir /= np.linalg.norm(class_dir, axis=-1, keepdims=True)
    if spec.n_groups > 1:
        gdir = rng.standard_normal((spec.n_groups, spec.n_features))
        gdir /= np.linalg.norm(gdir, axis=-1, keepdims=True)
        gid = rng.integers(0, spec.n_groups, size=spec.n_classes)
        class_dir = gdir[gid] + spec.within_group * class_dir
        class_dir /= np.linalg.norm(class_dir, axis=-1, keepdims=True)
    mode_off = rng.standard_normal(
        (spec.n_classes, spec.modes_per_class, spec.n_features))
    mode_off /= np.linalg.norm(mode_off, axis=-1, keepdims=True)
    means = (spec.sep * class_dir[:, None, :]
             + spec.mode_scale * spec.sep * mode_off)

    n_tr = min(spec.n_train, max_train) if max_train else spec.n_train
    n_te = min(spec.n_test, max_test) if max_test else spec.n_test
    x_tr, y_tr = _make_split(spec, n_tr, rng, means)
    x_te, y_te = _make_split(spec, n_te, rng, means)

    # standardize features with train statistics (usual UCI preprocessing)
    mu, sd = x_tr.mean(0, keepdims=True), x_tr.std(0, keepdims=True) + 1e-6
    return ((x_tr - mu) / sd, y_tr, (x_te - mu) / sd, y_te, spec)


def load_pool(name: str, n_batches: int, *, seed: int | None = None,
              max_train: int | None = None, batch_rows: int | None = None):
    """(x_train, y_train, x_pool, y_pool, spec): ``load_dataset``'s training
    split and its first test split, then ``n_batches - 1`` further test
    splits drawn on from the same generator, standardized with the training
    statistics.  x_pool is (n_batches, rows, F), rows = ``batch_rows`` or
    the spec's test size; batch 0 is ``load_dataset``'s test split
    whenever ``batch_rows`` is left at that size."""
    spec = DATASETS[name]
    rng = np.random.default_rng(seed if seed is not None else spec.seed)

    class_dir = rng.standard_normal((spec.n_classes, spec.n_features))
    class_dir /= np.linalg.norm(class_dir, axis=-1, keepdims=True)
    if spec.n_groups > 1:
        gdir = rng.standard_normal((spec.n_groups, spec.n_features))
        gdir /= np.linalg.norm(gdir, axis=-1, keepdims=True)
        gid = rng.integers(0, spec.n_groups, size=spec.n_classes)
        class_dir = gdir[gid] + spec.within_group * class_dir
        class_dir /= np.linalg.norm(class_dir, axis=-1, keepdims=True)
    mode_off = rng.standard_normal(
        (spec.n_classes, spec.modes_per_class, spec.n_features))
    mode_off /= np.linalg.norm(mode_off, axis=-1, keepdims=True)
    means = (spec.sep * class_dir[:, None, :]
             + spec.mode_scale * spec.sep * mode_off)

    n_tr = min(spec.n_train, max_train) if max_train else spec.n_train
    rows = batch_rows or spec.n_test
    x_tr, y_tr = _make_split(spec, n_tr, rng, means)
    splits = [_make_split(spec, rows, rng, means) for _ in range(n_batches)]
    mu, sd = x_tr.mean(0, keepdims=True), x_tr.std(0, keepdims=True) + 1e-6
    x_pool = np.stack([(x - mu) / sd for x, _ in splits])
    y_pool = np.stack([y for _, y in splits])
    return (x_tr - mu) / sd, y_tr, x_pool, y_pool, spec
