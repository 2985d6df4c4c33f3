"""Device time of the sweep kernels K2 and K3 (``k2_*``, ``k3_*``), a traced
job (ms, profiler)."""

from harness.trace import kernel_base_seconds

PREFIXES = ('k2_', 'k3_')


def read(ctx):
    s, n = kernel_base_seconds(ctx.kernels, PREFIXES)
    return 1e3 * s / ctx.jobs if n else None
