"""Quickstart on the PyTorch port: train LogHD on the ISOLET surrogate,
compare it with conventional HDC and SparseHD, and measure bit-flip
robustness, as ``examples/quickstart.py`` does with the JAX package.

Every method is built the same way:

    clf = make_classifier("loghd", n_classes=C, enc_cfg=enc_cfg, ...)
    clf = clf.fit(x_train, y_train, **shared)

and the robustness protocol is ``sweep_under_flips``: quantize the stored
leaves to 1 bit, flip each stored bit with probability p (one batched
``flip_corrupt`` launch a p-chunk on the card), predict.  The JAX
example's ``PRNGKey(0)`` is a CPU ``torch.Generator`` seeded with 0 here,
one for each sweep, as the JAX example passes one key to both.

    PYTHONPATH=src python examples/quickstart_torch.py            # the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu \\
        --max-train 400 --max-test 200 --dim 512 --refine-epochs 5 \\
        --retrain-epochs 3

The size flags exist for small CPU runs; their defaults are the JAX
example's: 4,000 / 1,000 rows, D = 10,000, 50 refine and 30 retrain
epochs.  Without ``--device`` it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.api import make_classifier
from repro_torch.data.synth import load_dataset
from repro_torch.hdc.conventional import class_prototypes
from repro_torch.hdc.encoders import EncoderConfig, encode_batched, fit_encoder
from repro_torch.kernels.common import resolve_device

P_GRID = [0.0, 0.1, 0.2, 0.3, 0.4]
N_TRIALS = 2


def run(x_tr, y_tr, x_te, y_te, spec, *, dim: int, device,
        refine_epochs: int = 50, retrain_epochs: int = 30, proj=None,
        bias=None, perms=None, seeds=None) -> dict:
    """The example's calls on given data.  ``proj`` / ``bias`` inject the
    encoder's draws, ``perms`` the (epochs, N) orders of LogHD's
    refinement, ``seeds`` the sweeps' per-leaf seeds ({"loghd": rows,
    "sparsehd": rows}); by default each is drawn from seed 0."""
    dev = resolve_device(device)
    c = spec.n_classes
    out = {"dataset": spec.name, "features": spec.n_features, "classes": c,
           "n_train": len(x_tr), "n_test": len(x_te), "dim": dim}
    print(f"dataset: {spec.name}  F={spec.n_features} C={c} "
          f"N={len(x_tr)}/{len(x_te)}  D={dim}")

    # One shared encoder + prototype set for every method (paper Sec. IV-A).
    enc_cfg = EncoderConfig(spec.n_features, dim, "cos")
    enc, h_tr = fit_encoder(enc_cfg, x_tr, device=dev, proj=proj, bias=bias)
    h_te = encode_batched(enc, x_te, "cos")
    y_tr_t = torch.as_tensor(y_tr, device=dev).long()
    protos = class_prototypes(h_tr, y_tr_t, c)
    shared = dict(prototypes=protos, enc=enc, encoded=h_tr)

    conv = make_classifier("conventional", c, enc_cfg=enc_cfg, device=dev)
    conv = conv.fit(x_tr, y_tr, **shared)
    out["acc_conventional"] = conv.accuracy(h_te, y_te)
    print(f"\nconventional HDC ({c}x{dim} = {c * dim / 1e3:.0f}k words): "
          f"acc={out['acc_conventional']:.3f}")

    log = make_classifier("loghd", c, enc_cfg=enc_cfg, device=dev, k=2,
                          extra_bundles=5, refine_epochs=refine_epochs,
                          codebook_method="distance")
    log = log.fit(x_tr, y_tr, perms=perms, **shared)
    n = log.model.n_bundles
    mem = log.model_bits(32) / conv.model_bits(32)
    out.update(n_bundles=n, memory_fraction=mem,
               acc_loghd=log.accuracy(h_te, y_te))
    print(f"LogHD (k=2, n={n}: {n * dim / 1e3:.0f}k words, {mem:.1%} of "
          f"baseline): acc={out['acc_loghd']:.3f}")

    sp = make_classifier("sparsehd", c, enc_cfg=enc_cfg, device=dev,
                         sparsity=1 - n / c, retrain_epochs=retrain_epochs)
    sp = sp.fit(x_tr, y_tr, **shared)
    out.update(sparsity=sp.cfg.sparsity, acc_sparsehd=sp.accuracy(h_te, y_te))
    print(f"SparseHD (S={sp.cfg.sparsity:.2f}, matched memory): "
          f"acc={out['acc_sparsehd']:.3f}")

    print("\nbit-flip robustness (1-bit models, bulk-memory scope):")
    seeds = seeds or {}
    sweeps = {}
    for name, clf in (("loghd", log), ("sparsehd", sp)):
        rows = seeds.get(name)
        gen = None if rows is not None else torch.Generator().manual_seed(0)
        sweeps[name] = clf.sweep_under_flips(1, P_GRID, h_te, y_te,
                                             n_trials=N_TRIALS, scope="hv",
                                             generator=gen, seeds=rows)
    la, sa = sweeps["loghd"].mean(axis=1), sweeps["sparsehd"].mean(axis=1)
    print("  p     LogHD  SparseHD")
    for p, l_acc, s_acc in zip(P_GRID, la, sa):
        print(f"  {p:.2f}  {l_acc:.3f}  {s_acc:.3f}")
    out.update(p_grid=list(P_GRID), sweep_loghd=sweeps["loghd"],
               sweep_sparsehd=sweeps["sparsehd"],
               sweep_mean_loghd=la, sweep_mean_sparsehd=sa,
               classifiers={"conventional": conv, "loghd": log,
                            "sparsehd": sp},
               h_te=h_te, y_te=np.asarray(y_te))
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--max-train", type=int, default=4000)
    ap.add_argument("--max-test", type=int, default=1000)
    ap.add_argument("--dim", type=int, default=10_000)
    ap.add_argument("--refine-epochs", type=int, default=50)
    ap.add_argument("--retrain-epochs", type=int, default=30)
    args = ap.parse_args(argv)
    x_tr, y_tr, x_te, y_te, spec = load_dataset(
        "isolet", max_train=args.max_train, max_test=args.max_test)
    return run(x_tr, y_tr, x_te, y_te, spec, dim=args.dim, device=args.device,
               refine_epochs=args.refine_epochs,
               retrain_epochs=args.retrain_epochs)


if __name__ == "__main__":
    main()
