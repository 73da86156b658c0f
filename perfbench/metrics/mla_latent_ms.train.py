"""mla_latent_ms.train: device milliseconds a training step put down to
the program's span ``repro_torch.mla.latent`` (``models/mla.MLA.forward``'s
latent stage: the q and kv compressions and their norms, YaRN's rotation,
the ``wkv_b`` expansion and the concatenation), with their backward and
remat's recomputation, by ``perfbench/spans.py``; None where the program
has no such span."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, Path(__file__).resolve().parents[2],
                           "repro_torch.mla.latent")
