"""attention_ms.train: device milliseconds a training step put down to
the program's span ``repro_torch.attention``
(``models/attention.Attention.forward``: the q, k, v projections, the
chunked attention, the output projection), with their backward and
remat's recomputation, by ``perfbench/spans.py``."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, Path(__file__).resolve().parents[2],
                           "repro_torch.attention")
