"""step_kernels_roofline: the step work's least time over the device time
of the kernels mapped to it (K5a, K5b), in %."""


def read(ctx):
    return ctx.roofline_pct("step_kernels", "solve")
