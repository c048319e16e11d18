"""On the card: each cell's command runs briefly from the repository root
and comes out correct. Skips without a card."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent
CELLS = [w["name"] for w in json.loads(
    (BENCH.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=1200, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
