"""Host reads of the solver's PCG stop test (``host_reads()["pcg"]``), a
traced job (a count)."""


def read(ctx):
    n = ctx.host_reads.get("pcg")
    return n / ctx.jobs if n else None
