"""riccati.idle_ms.batch: card idle ms per solve while "fddp.riccati" is
the innermost program span."""

import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("fddp.riccati",), "solve")
