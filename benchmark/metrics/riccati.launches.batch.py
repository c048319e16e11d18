"""riccati.launches.batch: device launches per solve made inside the span
"fddp.riccati" (the backward passes)."""

import program_spans


def read(ctx):
    return program_spans.launches(ctx, "fddp.riccati", "solve")
