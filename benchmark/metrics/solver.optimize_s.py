"""Synced walls of the ``ltslam.optimize.*`` stages summed, mean a traced
job (s)."""

STAGES = ('ltslam.optimize.',)


def read(ctx):
    hit = [v for k, v in ctx.stage_s.items() if k.startswith(STAGES)]
    return sum(hit) / ctx.jobs if hit else None
