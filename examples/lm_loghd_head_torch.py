"""The paper's technique as an LM-head compressor, on the PyTorch port, as
``examples/lm_loghd_head.py`` does with the JAX package: train a small
decoder LM with the dense unembedding and with the LogHD head (bundles +
vocab profiles) and compare loss trajectories and head sizes.

qwen3-1.7b's smoke config at vocab 2,048, d_model 128 and two periods,
float32; batches of 8 x 128 tokens from ``TokenPipeline``; AdamW at a
constant LR of 1e-3 and weight decay 0.01.  On the card the LogHD head's
logits come from the ``loghd_head`` kernel, one launch a step (its
backward runs in torch on the activations the forward kept).

    PYTHONPATH=src python examples/lm_loghd_head_torch.py [--steps 60]
    PYTHONPATH=src python examples/lm_loghd_head_torch.py --device cpu

Without ``--device`` it runs on the card and raises without one.
"""

from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models.convert import stacked_layers
from repro_torch.models.model import init_params, loss_fn
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update


def example_config(head: str):
    """The example's model: qwen3 smoke at vocab 2,048, d_model 128, two
    periods, with `head` and four extra LogHD bundles."""
    base = dataclasses.replace(get_smoke_config("qwen3-1.7b"), vocab=2048,
                               d_model=128, n_periods=2)
    return dataclasses.replace(base, head=head, loghd_extra=4)


def train(cfg, steps: int, seed: int = 0, *, device=None, params=None,
          batches=None):
    """`steps` AdamW steps; returns (losses, model).  ``params`` injects
    the initial model, ``batches`` a ``step -> {"tokens", "targets"}``
    source (default: ``init_params`` and ``TokenPipeline`` of `seed`)."""
    dev = resolve_device(device)
    if batches is None:
        batches = TokenPipeline(vocab=cfg.vocab, seq_len=128, global_batch=8,
                                seed=seed, device=dev).batch
    model = (init_params(cfg, seed=seed, device=dev) if params is None
             else params)
    opt_cfg = AdamWConfig(lr=1e-3, weight_decay=0.01)
    names = [n for n, _ in model.named_parameters()]
    opt = adamw_init(dict(model.named_parameters()), opt_cfg,
                     stacked_layers(model))

    def step(batch):
        loss = loss_fn(model, cfg, torch.as_tensor(batch["tokens"], device=dev),
                       torch.as_tensor(batch["targets"], device=dev))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        adamw_update(opt, dict(model.named_parameters()),
                     dict(zip(names, grads)), opt_cfg)
        return loss.detach()

    losses = [float(step(batches(i))) for i in range(steps)]
    return losses, model


def head_words(cfg):
    if cfg.head == "dense":
        return cfg.d_model * cfg.vocab
    n = cfg.loghd_bundles
    return n * cfg.d_model + cfg.vocab * n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    out = {}
    for head in ("dense", "loghd"):
        cfg = example_config(head)
        losses, _ = train(cfg, args.steps, device=args.device)
        hw = head_words(cfg)
        out[head] = {"head_words": hw, "losses": losses}
        print(f"head={head:<6} params={hw / 1e3:8.1f}k  "
              f"loss[0]={losses[0]:.3f}  loss[-5:]="
              f"{[round(v, 3) for v in losses[-5:]]}")
    print("\nNote: decode-step head FLOPs drop from 2*D*V to 2*D*n + 2*n*V.")
    return out


if __name__ == "__main__":
    main()
