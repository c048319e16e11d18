"""fddp.sync_wait_ms.batch: host ms per solve inside "fddp.sync", the host
waiting on the card for a flag."""

import program_spans


def read(ctx):
    return program_spans.wall_ms(ctx, "fddp.sync", "solve")
