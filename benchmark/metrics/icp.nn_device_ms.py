"""Device time of the ICP farm's 1-NN kernels K5b (``nn_*``), a traced job
(ms, profiler)."""

from harness.trace import kernel_base_seconds

PREFIXES = ('nn_',)


def read(ctx):
    s, n = kernel_base_seconds(ctx.kernels, PREFIXES)
    return 1e3 * s / ctx.jobs if n else None
