"""The harness on the host: every configuration, cell, metric and kernel
mapping is found by name; a file added to a folder adds an entry without
an edit; the result line's keys; and no card means no result."""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

import harness
import roofline
import traffic
from _small_cells import SEED, load, run_small

BENCH = Path(__file__).resolve().parent.parent
BENCH_JSON = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


# the numbers the batch FDDP loop's check compares
BATCH_NUMBERS = {"cost_rel", "gap_abs", "K_rel", "kkt_abs", "xs_abs",
                 "cost_opt_rel", "flags_pct"}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH_JSON["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.entry["config"]
    numbers = traffic.loop_module(c.mix["loop"]).NUMBERS
    assert set(c.limits) == set(numbers)
    if c.mix["loop"] == "batch":
        assert set(numbers) == BATCH_NUMBERS
    assert any(m["name"] == "setup_s" for m in c.end_to_end)
    assert len(c.end_to_end) >= 2 and c.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH_JSON["end_to_end"]
                                    + BENCH_JSON["per_layer"]])
def test_every_metric_has_a_reader(metric):
    assert callable(harness.reader(metric))


def test_a_file_added_to_a_folder_adds_an_entry(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    (root / "kernels" / "fused_tick_kernel.json").write_text(json.dumps(
        {"work": "stage_derivs", "nodes_per_launch": "T*B",
         "group": "stage_kernels"}))
    assert "fused_tick_kernel" in roofline.kernel_map(root)
    (root / "metrics" / "extra.count.tick.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    assert harness.reader("extra.count.tick", root)(None) == 42.0
    b = json.loads((tmp_path / "BENCHMARK.json").read_text())
    b["workloads"].append(dict(b["workloads"][0], name="tiago-extra"))
    (root / "cells" / "tiago-extra.json").write_text(
        (root / "cells" / f"{b['workloads'][0]['name']}.json").read_text())
    cell = harness.load_cell("tiago-extra", root, bench=b)
    assert cell.mix == harness.load_cell(b["workloads"][0]["name"]).mix


# A loop of new files alone: the batch loop's problem and check, with the
# dense Riccati sweep in the solver.
DENSE_LOOP = '''"""Batch FDDP solves with the dense Riccati sweep."""
from pathlib import Path

import traffic

_batch = traffic.loop_module("batch", Path(__file__).resolve().parents[1])
NUMBERS, build_problem, check = _batch.NUMBERS, _batch.build_problem, _batch.check


class Loop(_batch.Loop):
    def __init__(self, problem, mix, seed, device):
        from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

        super().__init__(problem, mix, seed, device)
        self.solver = make_batch_fddp(problem.model, problem.params,
                                      problem.spec, self.settings,
                                      riccati="dense", device=self.device)
'''


def _tree(root: Path) -> dict:
    return {p.relative_to(root): p.read_bytes()
            for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_brings_its_own_loop_as_new_files(tmp_path):
    root = tmp_path / "benchmark"
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree(root)
    b = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    old = b["workloads"][0]
    (root / "loops" / "batch_dense.py").write_text(DENSE_LOOP)
    mix = json.loads((root / "traffic" / f"{old['traffic']}.json").read_text())
    (root / "traffic" / "batch-dense.json").write_text(
        json.dumps(dict(mix, loop="batch_dense")))
    (root / "cells" / "tiago-dense.json").write_text(
        (root / "cells" / f"{old['name']}.json").read_text())
    b["workloads"].append(dict(old, name="tiago-dense", traffic="batch-dense"))
    for m in b["end_to_end"] + b["per_layer"]:
        if old["name"] in m.get("workloads", []):
            m["workloads"].append("tiago-dense")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    after = _tree(root)
    assert {k: after[k] for k in before} == before  # no file edited

    cell = harness.load_cell("tiago-dense", root, bench=b)
    out = harness.run_cell(cell, SEED, 0.01, False, "cpu",
                           time.perf_counter(), horizon=6, batch=4)
    assert out["correct"] is True, out["checks"]
    assert set(out["checks"]) == BATCH_NUMBERS
    assert set(out["metrics"]) == {"solves_per_s", "setup_s"}
    problem = harness.build_problem(cell, "cpu", horizon=2)
    loop = traffic.make_loop(problem, dict(cell.mix, batch=2), SEED, "cpu",
                             root)
    assert loop.solver.riccati == "dense"
    assert loop.sizes() == dict(T=2, B=2, nj=17)


@pytest.mark.parametrize("name", ["no_such_loop", "../harness", ""])
def test_an_unknown_loop_is_refused(name):
    cell = load("panda-t20-batch4096")
    cell.mix = dict(cell.mix, loop=name)
    with pytest.raises(ValueError, match="no loop"):
        harness.build_problem(cell, "cpu", horizon=2)
    with pytest.raises(ValueError, match="loops/<name>.py"):
        traffic.make_loop(None, cell.mix, SEED, "cpu")


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    out = run_small("panda-t20-batch4096", trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(out) == want
    assert out["correct"] is True
    cell = load("panda-t20-batch4096")
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(out["metrics"]) <= names
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"busy_s", "window_s"} <= set(out["device"])
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_measuring_path_refuses_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        harness.require_cuda(1)
    cell = harness.load_cell("tiago-full-t20-batch4096")
    with pytest.raises(RuntimeError):
        harness.run_cell(cell, 1, 0.1, False, "cuda", 0.0, horizon=2,
                         batch=2)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "tiago-full-t20-batch4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=BENCH.parent)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
