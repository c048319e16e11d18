"""fddp.host_syncs.batch: BatchFDDP.host_syncs per solve."""


def read(ctx):
    return ctx.per_unit("fddp.host_syncs", "solve")
