"""Cells shrunk to what a host test can hold, run on the CPU with the
program's plain versions (the harness's look for a card is skipped).

Besides the cells of `BENCHMARK.json`, the Panda's batch cell, which the
benchmark keeps under its open questions (its configuration, traffic and
limits are files here), is added for the tests."""

from __future__ import annotations

import copy
import json
import time
from pathlib import Path

import harness

BENCH_JSON = json.loads(
    (Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
PANDA = {"name": "panda-t20-batch4096", "config": "panda-goal-t20",
         "traffic": "batch-fddp-b4096", "chips": 1,
         "why": "FDDP solves of 4096 seeded Panda scenarios, T=20"}
SMALL = {"panda-t20-batch4096": dict(horizon=20, batch=4),
         "tiago-full-t20-batch4096": dict(horizon=6, batch=4)}
SEED = 2 ** 31 + 11  # past 32 signed bits: seeds may be that large


def bench() -> dict:
    """`BENCHMARK.json` with the Panda cell added."""
    b = copy.deepcopy(BENCH_JSON)
    b["configs"].append({"name": "panda-goal-t20",
                         "file": "benchmark/configs/panda-goal-t20.json"})
    b["workloads"].append(PANDA)
    for m in b["end_to_end"] + b["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(PANDA["name"])
    return b


def load(name):
    return harness.load_cell(name, bench=bench())


def run_small(name, seed=SEED, trace=False, seconds=0.01):
    """One run of the shrunk cell `name` on the CPU: the result line."""
    return harness.run_cell(load(name), seed, seconds, trace, "cpu",
                            time.perf_counter(), **SMALL[name])
