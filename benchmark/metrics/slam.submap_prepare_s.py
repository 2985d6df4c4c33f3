"""Synced wall of ``ltslam.sc_loops.prepare`` (the ICP pairs' submaps), mean
a traced job (s)."""

STAGES = ('ltslam.sc_loops.prepare',)


def read(ctx):
    hit = [v for k, v in ctx.stage_s.items() if k in STAGES]
    return sum(hit) / ctx.jobs if hit else None
