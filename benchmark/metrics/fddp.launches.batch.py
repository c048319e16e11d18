"""fddp.launches.batch: device launches per solve made inside "fddp.solve",
every span nested in it included."""

import program_spans


def read(ctx):
    return program_spans.launches(ctx, "fddp.solve", "solve")
