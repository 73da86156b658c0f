"""mlp_ms.train: device milliseconds a training step put down to the
program's span ``repro_torch.mlp`` (``models/layers.GatedMLP``: a dense
layer's SwiGLU), with its backward and remat's recomputation, by
``perfbench/spans.py``; None where the program has no such span."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, Path(__file__).resolve().parents[2],
                           "repro_torch.mlp")
