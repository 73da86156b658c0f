"""head_ms.train: device milliseconds a training step put down to the
program's span ``repro_torch.head`` (``models/model.loss_fn``, a loss
chunk at a time: the LogHD head through ``api/dispatch.loghd_head_scores``
-> ``kernels/loghd_head``, and the cross entropy), with their backward and
the chunk's recomputation, by ``perfbench/spans.py``."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, Path(__file__).resolve().parents[2],
                           "repro_torch.head")
