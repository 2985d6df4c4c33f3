"""Share of the traced window in which no operation ran on the device (%):
1 - the union of the profiler's device intervals over the window."""


def read(ctx):
    return 100.0 * (1.0 - ctx.busy_s / ctx.window_s) if ctx.window_s > 0 else None
