"""optimizer_ms.train: device milliseconds a training step put down to
the program's span ``repro_torch.train.optimizer``
(``runtime/train_loop.make_train_step`` around ``optim/adamw``'s update:
the clip, the moments and the weights), by ``perfbench/spans.py``."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.device_ms(ctx, Path(__file__).resolve().parents[2],
                           "repro_torch.train.optimizer")
