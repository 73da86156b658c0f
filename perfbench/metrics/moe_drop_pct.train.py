"""moe_drop_pct.train: the share, in %, of the traced window's choices on
held experts that the capacity dropped (they fall through the residual),
from the program's routing counters (``models/moe.routing_counters``)
that the driver reads once after the window into ``counts``.  A step made
faster by dropping more tokens shows here.  None where the program has no
such counters."""


def read(ctx):
    held = ctx.counts.get("held_choices")
    if not held:
        return None
    return 100.0 * ctx.counts["dropped_choices"] / held
