"""The control of `correct`: the reference in TF32 put in the program's
place, beside the program's own readings, on several seeds of one cell in
one process.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds 1 2 3 [--check-rows n]

For each seed: the cell's set-up and a window of `--seconds`, then the
numbers compared, once for the program's outputs and once for the
reference's own solve of the same rows in float32 with TF32 products, both
against the float64 reference. Prints one JSON line per seed. The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def readings(cell, seed, seconds, device, horizon=None, batch=None,
             check_rows=None):
    """(the program's numbers, the control's numbers, units run) of one
    seed; `check_rows` rows kept a unit instead of the mix's, so that a
    short window compares as many rows as a run does."""
    from traffic import make_loop

    import harness

    mix = dict(cell.mix)
    if batch is not None:
        mix["batch"] = batch
    if check_rows is not None:
        mix["check_rows"] = check_rows
    problem = harness.build_problem(cell, device, horizon)
    loop = make_loop(problem, mix, seed, device, cell.root)
    loop.setup()
    t0 = time.perf_counter()
    while loop.units == 0 or time.perf_counter() - t0 < seconds:
        loop.unit()
    loop.release()
    prog, ctl = harness.check(cell, problem, loop, device, control=True)
    return prog, ctl, loop.units


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--check-rows", type=int, default=None)
    args = ap.parse_args(argv)

    import harness

    cell = harness.load_cell(args.workload)
    harness.require_cuda(cell.entry["chips"])
    print(f"card: {harness.power_line()}", file=sys.stderr, flush=True)
    for seed in args.seeds:
        t0 = time.perf_counter()
        prog, ctl, units = readings(cell, seed, args.seconds, "cuda",
                                    check_rows=args.check_rows)
        print(json.dumps({"cell": cell.name, "seed": seed, "units": units,
                          "seconds": time.perf_counter() - t0,
                          "program": prog, "control": ctl}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
