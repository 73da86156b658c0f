"""100M-word-scale streaming HD training on the PyTorch port, as
``examples/train_100m.py`` does with the JAX package.

Streams synthetic class-conditional shards (fixed class geometry, fresh
samples per shard) through ``fit_engine.fused_onlinehd_fit_dp``: each
shard is encoded (``hdc_encode`` on the card), split over the data axis
of ``launch.mesh.make_debug_mesh()``, and consumed in ``global-batch``
steps whose prototype deltas are all-reduced through the int8
error-feedback ``compressed_psum`` (``optim/grad_compress.py``).
Prototypes carry across shards, so the run is one online pass over about
100M encoded words (shards x examples x D).

A single process makes a process group of one rank (NCCL on the card,
gloo with ``--device cpu``).  The JAX example's ``--devices N`` forces N
host devices into XLA; here the ranks are processes, so run N of them
under ``torchrun`` instead (each joins the group ``torchrun`` sets up):

    PYTHONPATH=src python examples/train_100m_torch.py          # the card
    PYTHONPATH=src torchrun --nproc_per_node=4 examples/train_100m_torch.py
    PYTHONPATH=src python examples/train_100m_torch.py --device cpu \\
        --shards 2 --shard-size 256 --dim 256

The size flags exist for small CPU runs; their defaults are the JAX
example's: 12 shards x 4,096 examples x D = 2,048.  Without ``--device``
it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import time


def _parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--shards", type=int, default=12)
    ap.add_argument("--shard-size", type=int, default=4096)
    ap.add_argument("--dim", type=int, default=2048)
    ap.add_argument("--dataset", default="isolet")
    ap.add_argument("--global-batch", type=int, default=256)
    ap.add_argument("--epochs-per-shard", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress", choices=["int8", "none"], default="int8")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap.parse_args(argv)


def class_means(spec):
    """The fixed class geometry every shard is drawn from (the preamble of
    ``data.synth.load_dataset``, one seed for the whole stream)."""
    import numpy as np
    rng = np.random.default_rng(spec.seed)
    class_dir = rng.standard_normal((spec.n_classes, spec.n_features))
    class_dir /= np.linalg.norm(class_dir, axis=-1, keepdims=True)
    mode_off = rng.standard_normal(
        (spec.n_classes, spec.modes_per_class, spec.n_features))
    mode_off /= np.linalg.norm(mode_off, axis=-1, keepdims=True)
    return (spec.sep * class_dir[:, None, :]
            + spec.mode_scale * spec.sep * mode_off)


def main(argv=None, *, proj=None, bias=None) -> dict:
    """Run the stream; ``proj`` / ``bias`` inject the encoder's draws
    (default: drawn from seed 0)."""
    args = _parse_args(argv)

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.api import fit_engine
    from repro_torch.data.synth import DATASETS, _make_split
    from repro_torch.hdc.conventional import class_prototypes
    from repro_torch.hdc.encoders import (EncoderConfig, encode_batched,
                                          fit_encoder)
    from repro_torch.kernels.common import resolve_device
    from repro_torch.launch.mesh import join_group, make_debug_mesh
    from repro_torch.precision import full_f32

    dev = resolve_device(args.device)
    made = join_group(dev)
    try:
        spec = DATASETS[args.dataset]
        compress = None if args.compress == "none" else args.compress
        mesh = make_debug_mesh(dev)
        n_dev = int(mesh.shape["data"])
        words = args.shards * args.shard_size * args.dim
        print(f"streaming {args.shards} shards x {args.shard_size} examples "
              f"x D={args.dim} = {words / 1e6:.0f}M encoded words over "
              f"{n_dev} rank(s), compress={compress}")
        means = class_means(spec)

        def shard(i, n):
            x, y = _make_split(spec, n, np.random.default_rng(1000 + i),
                               means)
            return x, torch.as_tensor(y, device=dev).long()

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        # encoder calibrated on shard 0; prototypes superposed from it,
        # then refined online across the remaining stream
        enc_cfg = EncoderConfig(spec.n_features, args.dim, "cos")
        x0, y0 = shard(0, args.shard_size)
        enc, h0 = fit_encoder(enc_cfg, x0, device=dev, proj=proj, bias=bias)
        protos = class_prototypes(h0, y0, spec.n_classes)

        x_te, y_te = shard(10_000, 2048)          # held-out evaluation shard
        h_te = encode_batched(enc, x_te, "cos")

        @full_f32()
        def accuracy(p):
            return float((torch.argmax(h_te @ p.T, dim=-1) == y_te)
                         .float().mean())

        acc0 = accuracy(protos)
        print(f"shard 0 (superposition only): acc {acc0:.4f}")
        sync()
        t0 = time.perf_counter()
        seen = 0
        log = []
        for i in range(args.shards):
            x, y = (x0, y0) if i == 0 else shard(i, args.shard_size)
            h = h0 if i == 0 else encode_batched(enc, x, "cos")
            protos = fit_engine.fused_onlinehd_fit_dp(
                protos, h, y, lr=args.lr, batch_size=args.global_batch,
                epochs=args.epochs_per_shard, mesh=mesh, compress=compress)
            sync()
            seen += h.shape[0]
            if i % 4 == 3 or i == args.shards - 1:
                dt = time.perf_counter() - t0
                rate = seen * args.dim / dt
                acc = accuracy(protos)
                log.append({"shard": i, "seen": seen, "words_per_s": rate,
                            "acc": acc})
                print(f"shard {i}: {seen} examples "
                      f"({rate / 1e6:.1f}M words/s incl. encode), "
                      f"acc {acc:.4f}")
        dt = time.perf_counter() - t0
        final = accuracy(protos)
        print(f"done: {args.shards} shards, {seen} examples, "
              f"{seen * args.dim / 1e6:.0f}M encoded words in {dt:.1f}s; "
              f"final acc {final:.4f}")
        return {"ranks": n_dev, "compress": compress, "words": words,
                "acc_superposition": acc0, "log": log, "examples": seen,
                "seconds": dt, "words_per_s": seen * args.dim / dt,
                "final_acc": final, "protos": protos}
    finally:
        if made:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
