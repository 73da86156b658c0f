"""dispatch_gap_ms.train: milliseconds a training step in which the card
is idle and the host is in one of the program's ``repro_torch.*`` spans:
the device waiting on the program's host code.  Each idle stretch that
begins inside ``perfbench.train_step`` is put down to a span by
``perfbench/spans.py``."""

from pathlib import Path

from perfbench import spans


def read(ctx):
    return spans.idle_ms(ctx, Path(__file__).resolve().parents[2])
