"""cost_packs.launches.batch: device launches per solve made inside the
span "fddp.costs" (the cost-pack evaluations)."""

import program_spans


def read(ctx):
    return program_spans.launches(ctx, "fddp.costs", "solve")
