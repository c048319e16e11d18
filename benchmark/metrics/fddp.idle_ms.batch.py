"""fddp.idle_ms.batch: card idle ms per solve while "fddp.solve" or
"fddp.sync" is the innermost program span (the loop glue, the step-kernel
wrappers, the host syncs)."""

import program_spans


def read(ctx):
    return program_spans.idle_ms(ctx, ("fddp.solve", "fddp.sync"), "solve")
