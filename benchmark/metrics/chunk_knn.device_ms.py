"""Device time of the chunked kNN K4, a traced job (ms, profiler): its own
kernels (``ck_*``) and CUB's radix sort that it launches between its keys
(``ck_keys``) and its bounds (``ck_bounds``); CUB kernels elsewhere belong
to other callers."""

from harness.trace import base_name


def read(ctx):
    total, n, inside = 0.0, 0, False
    for k in sorted(ctx.kernels, key=lambda k: k.start):
        b = base_name(k.name)
        if b.startswith("ck_"):
            total, n = total + k.dur, n + 1
            inside = b == "ck_keys"
        elif inside and "Radix" in b:
            total += k.dur
    return 1e3 * total / ctx.jobs if n else None
