"""LogHD for extreme multi-class on the PyTorch port, as
``examples/extreme_classification.py`` does with the JAX package: the
regime where O(D log_k C) beats O(C D).

C = 4,096 synthetic classes, D = 8,192: the conventional model stores 33.6M
words; LogHD with k=2, n=14 stores 0.172M (14 x 8,192 bundle words and
4,096 x 14 profile words, 195x smaller), and a query costs 14 similarity
lanes + a 4,096 x 14 decode instead of 4,096 full-width dots.
On the card the conventional predict is one ``bundle_sim`` launch over the
4,096 prototypes; LogHD's is ``bundle_sim`` over 14 bundles, then
``profile_decode`` over the 4,096 profiles.  Past one card's C, pass
``class_sharding=S`` (``repro_torch.api.sharded``).

    PYTHONPATH=src python examples/extreme_classification_torch.py   # card
    PYTHONPATH=src python examples/extreme_classification_torch.py \\
        --device cpu --classes 64 --dim 512

The size flags exist for small CPU runs; their defaults are the JAX
example's.  Queries/s time 3 predicts of the 2,048 test rows after
one warm-up, each ended by ``torch.cuda.synchronize`` on the card;
``encode_s`` is the wall of the encoder's fit and the test rows' encode.
Without ``--device`` it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.api import make_classifier
from repro_torch.core.codebook import min_bundles
from repro_torch.hdc.conventional import class_prototypes
from repro_torch.hdc.encoders import EncoderConfig, encode_batched, fit_encoder
from repro_torch.kernels.common import resolve_device


def make_data(c=4096, f=256, d_per_class=24, n_test=2048, seed=0):
    rng = np.random.default_rng(seed)
    dirs = rng.standard_normal((c, f)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    y_tr = np.repeat(np.arange(c), d_per_class)
    x_tr = dirs[y_tr] * 2.0 + rng.standard_normal(
        (len(y_tr), f)).astype(np.float32) * (1.0 / np.sqrt(f))
    y_te = rng.integers(0, c, n_test)
    x_te = dirs[y_te] * 2.0 + rng.standard_normal(
        (n_test, f)).astype(np.float32) * (1.0 / np.sqrt(f))
    return x_tr, y_tr.astype(np.int32), x_te, y_te.astype(np.int32)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_predict(clf, h_te, reps=3):
    """Steady-state queries/s: one warm-up predict, then the mean over
    `reps` completed predicts (synchronised, or the clock reads the
    enqueue, not the work)."""
    clf.predict_encoded(h_te)
    _sync(h_te.device)
    t0 = time.perf_counter()
    for _ in range(reps):
        clf.predict_encoded(h_te)
    _sync(h_te.device)
    dt = (time.perf_counter() - t0) / reps
    return h_te.shape[0] / dt


def run(x_tr, y_tr, x_te, y_te, c: int, d: int, *, device, reps: int = 3,
        proj=None, bias=None) -> dict:
    """The example's calls on given data; ``proj`` / ``bias`` inject the
    encoder's draws (default: drawn from seed 0)."""
    dev = resolve_device(device)
    print(f"extreme classification: C={c}, D={d}, train={len(x_tr)}")

    enc_cfg = EncoderConfig(x_tr.shape[1], d, "cos")
    _sync(dev)
    t0 = time.perf_counter()
    enc, h_tr = fit_encoder(enc_cfg, x_tr, device=dev, proj=proj, bias=bias)
    h_te = encode_batched(enc, x_te, "cos")
    _sync(dev)
    encode_s = time.perf_counter() - t0
    protos = class_prototypes(h_tr, torch.as_tensor(y_tr, device=dev).long(),
                              c)

    conv = make_classifier("conventional", c, enc_cfg=enc_cfg, device=dev)
    conv = conv.fit(x_tr, y_tr, prototypes=protos, enc=enc, encoded=h_tr)
    qps_conv = _timed_predict(conv, h_te, reps)
    acc_conv = conv.accuracy(h_te, y_te)

    n_min = min_bundles(c, 2)
    log = make_classifier("loghd", c, enc_cfg=enc_cfg, device=dev, k=2,
                          extra_bundles=2, refine_epochs=0,
                          codebook_method="stratified")
    log = log.fit(x_tr, y_tr, prototypes=protos, enc=enc, encoded=h_tr)
    qps_log = _timed_predict(log, h_te, reps)
    acc = log.accuracy(h_te, y_te)

    # stored bytes from the models (QTensor-aware), not hand-counted words
    conv_bytes = conv.model.stored_bytes()
    log_bytes = log.model.stored_bytes()
    n = log.model.n_bundles
    print(f"conventional: {conv_bytes / 1e6:.1f} MB stored, "
          f"acc={acc_conv:.3f}, {qps_conv:.0f} queries/s")
    print(f"LogHD k=2 n={n} (min {n_min}): {log_bytes / 1e6:.3f} MB stored "
          f"({conv_bytes / log_bytes:.0f}x smaller, "
          f"{log_bytes / conv_bytes:.2%} of baseline), acc={acc:.3f}, "
          f"{qps_log:.0f} queries/s")
    return {"classes": c, "dim": d, "n_train": len(x_tr),
            "conventional_bytes": conv_bytes, "acc_conventional": acc_conv,
            "qps_conventional": qps_conv, "n_bundles": n, "n_min": n_min,
            "loghd_bytes": log_bytes, "acc_loghd": acc, "qps_loghd": qps_log,
            "encode_s": encode_s,
            "classifiers": {"conventional": conv, "loghd": log},
            "h_te": h_te, "y_te": y_te}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--classes", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=8192)
    args = ap.parse_args(argv)
    x_tr, y_tr, x_te, y_te = make_data(c=args.classes)
    return run(x_tr, y_tr, x_te, y_te, args.classes, args.dim,
               device=args.device)


if __name__ == "__main__":
    main()
