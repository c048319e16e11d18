"""cost_packs.idle_ms.batch: card idle ms per solve while "fddp.costs" is
the innermost program span."""

import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("fddp.costs",), "solve")
