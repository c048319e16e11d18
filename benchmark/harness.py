"""One run of one benchmark cell: set-up, the measured (or traced) window,
the check against the reference, and the result line.

Everything a cell needs is found by name from `BENCHMARK.json`: the
configuration (`configs/<name>.json` and its URDF), the traffic mix
(`traffic/<name>.json`) and the loop it names (`loops/<loop>.py`: the
solver loop, the problem it solves and the check of its outputs; see
`traffic.py`), the cell's limits (`cells/<name>.json`) and one reader per
metric (`metrics/<name>.py`, a function `read(ctx)` that returns
a number, or None when the run has nothing for it to read).
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

import traffic

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "agimus_controller_tpu")
# the traced window: whole ticks or solves until this many seconds (at most
# the run's), enough units for the per-layer readings and few enough
# device events to reduce in seconds
TRACE_SECONDS = 10.0


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def load_cell(name: str, root: Path = HERE, bench=None, limits=None):
    """The cell `name` with its configuration, traffic mix, limits (its
    file's, or `limits`) and the metrics it reports."""
    bench = load_json(root.parent / "BENCHMARK.json") if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    config = load_json(root.parent / entry["file"])
    config["name"] = w["config"]
    in_cell = lambda m: name in m.get("workloads", [name])
    return SimpleNamespace(
        name=name, entry=w, config=config, root=root,
        urdf=(root / "configs" / config["urdf"]).read_text(),
        mix=load_json(root / "traffic" / f"{w['traffic']}.json"),
        limits=(load_json(root / "cells" / f"{name}.json")["limits"]
                if limits is None else limits),
        end_to_end=[m for m in bench["end_to_end"] if in_cell(m)],
        per_layer=[m for m in bench["per_layer"] if in_cell(m)],
        run_seconds=bench["run_seconds"])


def reader(metric: str, root: Path = HERE):
    """The `read` function of `metrics/<metric>.py`."""
    path = root / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def require_cuda(chips: int):
    """Raises unless the card count the cell asks for is there."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise RuntimeError(f"the cell needs {chips} cards, "
                           f"{torch.cuda.device_count()} found")


def power_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not read: {e}"


def build_problem(cell, device, horizon=None):
    """The program's model, spec and refs for the cell, and the
    reference's ready state and goals, as the cell's loop module builds
    them (`loops/<loop>.py`, `traffic.loop_module`)."""
    if str(REPO) not in sys.path:
        sys.path.insert(1, str(REPO))  # the checkout's port, after this folder
    return traffic.loop_module(cell.mix["loop"], cell.root).build_problem(
        cell, device, horizon)


def check(cell, problem, loop, device, control=False):
    """The numbers compared for the loop's sampled rows, and with
    `control` (second) the control's, else None: the cell's loop module's
    `check`."""
    return traffic.loop_module(cell.mix["loop"], cell.root).check(
        cell, problem, loop, device, control)


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of every limited number; a number the
    run could not give reads None and fails."""
    return {k: {"value": numbers.get(k), "limit": lim}
            for k, lim in limits.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] is not None and c["value"] <= c["limit"]
               for c in checks.values())


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, horizon=None, batch=None):
    """One run of `cell` on `device`: returns the result line's dict.
    `horizon` and `batch` shrink the cell (tests on the host only)."""
    from metrics_context import Context

    device = torch.device(device)
    on_card = device.type == "cuda"
    mix = dict(cell.mix)
    if batch is not None:
        mix["batch"] = batch
    problem = build_problem(cell, device, horizon)
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (
        lambda: None)
    loop = traffic.make_loop(problem, mix, seed, device, cell.root)
    loop.setup()
    sync()
    setup_s = time.perf_counter() - t_start
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    def window(limit):
        """Whole units until `limit` seconds have passed, then the card
        drained: the window's ends on the host clock."""
        t0 = time.perf_counter()
        while loop.units == 0 or time.perf_counter() - t0 < limit:
            loop.unit()
        sync()
        return t0, time.perf_counter()

    summary = prof = None
    c0 = loop.counters()
    if trace:
        import tracing

        prof = tracing.profiler()
        with prof:
            with torch.profiler.record_function(tracing.WINDOW_SPAN):
                t0, t1 = window(min(seconds, TRACE_SECONDS))
        summary = tracing.summarize(prof)
    else:
        t0, t1 = window(seconds)
    c1 = loop.counters()
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    loop.release()
    if on_card:
        torch.cuda.empty_cache()
    checks = judge(check(cell, problem, loop, device)[0], cell.limits)
    bad = int(loop.bad_rows)
    ctx = Context(cell=cell, loop=loop, t0=t0, t1=t1, setup_s=setup_s,
                  counters={k: c1[k] - c0.get(k, 0) for k in c1},
                  trace=summary, profile=prof, sizes=loop.sizes())
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"], cell.root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": bad == 0 and passed(checks),
           "attempted": ctx.counters["rows"], "failed": bad,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown
    out["checks"] = checks
    return out
