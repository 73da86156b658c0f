"""launches_per_step.train: device operations (kernels, copies, memsets) a
training step, from the trace: those launched inside the harness ranges
``perfbench.train_step`` over the number of such ranges."""


def read(ctx):
    steps = ctx.traced.span_count("perfbench.train_step")
    if not steps:
        return None
    ops = sum(1 for op in ctx.traced.ops if op.span == "perfbench.train_step")
    return ops / steps
