"""device.idle_pct.batch: share of the traced window with nothing running on
the card, batch solves."""


def read(ctx):
    return ctx.idle_pct("solve")
