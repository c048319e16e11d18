"""riccati.device_ms.batch: device ms per solve of the launches made inside
"fddp.riccati"."""

import program_spans


def read(ctx):
    return program_spans.device_ms(ctx, "fddp.riccati", "solve")
