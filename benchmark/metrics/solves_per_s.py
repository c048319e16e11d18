"""solves_per_s: scenarios solved in the window over the window's length."""


def read(ctx):
    if ctx.unit != "solve":
        return None
    return ctx.counters["rows"] / (ctx.t1 - ctx.t0)
