"""setup_s: process start to the first measured tick or solve."""


def read(ctx):
    return ctx.setup_s
