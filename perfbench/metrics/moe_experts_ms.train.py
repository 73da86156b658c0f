"""moe_experts_ms.train: device milliseconds a training step put down to
the program's span ``repro_torch.moe.experts`` (``models/moe.MoE.routed``
after the routing: the dispatch into the (E, cap, D) buffers, every
expert's SwiGLU, the gated combine), with their backward and remat's
recomputation, by ``perfbench/spans.py``."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, Path(__file__).resolve().parents[2],
                           "repro_torch.moe.experts")
