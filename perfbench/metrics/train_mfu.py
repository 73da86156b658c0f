"""train_mfu: the training step's share of the card's peak.

The frozen analytic FLOPs of a step (``perfbench/frozen/flops.py``: 3 x
the forward's 2 FLOPs a non-embedding active parameter a token plus
causal attention) times the steps of the traced window, over the window's
seconds, against the dense bf16 peak.  The work is counted whatever
implements it: a recomputation under remat, the capacity's padding of
the expert buffers and the attention's masked half are not counted.
"""

from perfbench.frozen import flops, peaks

PEAK = "H100 dense bf16 tensor-core flop/s (SXM: 989e12)"


def step_flops(cfg: dict, traffic: dict) -> float:
    shape = flops.model_shape(cfg["model"])
    return flops.analytic_flops(shape, traffic["seq_len"], traffic["batch"],
                                "train")["total"]


def read(ctx):
    steps = ctx.counts.get("steps", 0)
    if not steps:
        return None
    rate = steps * step_flops(ctx.config, ctx.traffic) / ctx.traced.window_s
    return 100.0 * rate / peaks.rates(ctx.card)["bf16"]
