"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Builds the cell's problem in the program (`agimus_controller_tpu_torch`)
on the card, sets up (kernel library load, solver construction, the
loop's own warm-up), runs the loop for `--seconds` (with `--trace 1`, whole
ticks or solves under the profiler instead), checks the sampled rows
against the float64 reference and prints, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics, device, with
`--trace 1` breakdown, and last the numbers compared with their limits
(`checks`), which also end standard error. Exits non-zero, printing no
result, without the cards the cell asks for, or when JAX, flax or the JAX
package is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness
    import torch

    torch.set_num_threads(1)  # one host thread: the loop only launches work
    cell = harness.load_cell(args.workload)
    try:
        harness.require_cuda(cell.entry["chips"])
    except RuntimeError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(f"card: {harness.power_line()}", file=sys.stderr, flush=True)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
