"""plain_torch.device_ms.batch: device ms per solve of the kernels that
are not the program's own."""


def read(ctx):
    return ctx.other_device_ms("solve")
