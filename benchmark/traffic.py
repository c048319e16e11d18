"""The traffic generator: a traffic mix (`traffic/<name>.json`) names its
loop ("loop"), and the loop's module (`loops/<loop>.py`, found by that
name) drives the program's solver over the seeded inputs in a closed loop.

A loop module defines:
- `Loop(problem, mix, seed, device)`: `B`, `nj`, `units`, `unit_name`,
  `solver_name`, `bad_rows`, `setup()`, `unit()`, `counters()`, `rows()`,
  `warm_start(n)`, `release()` and `sizes()` (the sizes the roofline's
  formulas name);
- `build_problem(cell, device, horizon)`: the program's model, spec and
  refs, and the reference's ready state and goals;
- `check(cell, problem, loop, device, control)`: the numbers compared, and
  the control's (or None);
- `NUMBERS`: the names of the numbers `check` returns.
It imports only the benchmark's `reference` and the program.
"""

from __future__ import annotations

import importlib.util
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
_NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def loop_module(name: str, root: Path = HERE):
    """The module `loops/<name>.py` under the benchmark folder `root`."""
    path = Path(root) / "loops" / f"{name}.py"
    if not (isinstance(name, str) and _NAME.fullmatch(name)
            and path.is_file()):
        known = sorted(p.stem for p in (Path(root) / "loops").glob("*.py"))
        raise ValueError(f"no loop {name!r}: the traffic mix names a loop "
                         f"that has no file loops/<name>.py (there are "
                         f"{', '.join(known)})")
    spec = importlib.util.spec_from_file_location(
        "bench_loop_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_loop(problem, mix: dict, seed: int, device, root: Path = HERE):
    """The mix's loop over `problem`, not yet set up."""
    return loop_module(mix["loop"], root).Loop(problem, mix, seed, device)
