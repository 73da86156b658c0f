"""device_idle.train: The share of the traced window in which no kernel, copy or memset runs
on the card: one minus the union of the device operations' intervals
over the window."""


def read(ctx):
    if not ctx.traced.ops:
        return None
    return 100.0 * (1.0 - ctx.traced.busy_s / ctx.traced.window_s)
