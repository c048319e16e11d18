"""fddp.iters.batch: FDDP iterations per scenario."""


def read(ctx):
    return ctx.per_row("fddp.iters", "solve")
