"""cost_packs.device_ms.batch: device ms per solve of the launches made
inside "fddp.costs"."""

import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "fddp.costs", "solve")
