"""Nothing the benchmark loads brings in JAX, jaxlib, flax or the JAX
package (compared by whole top-level module name: the port's name begins
with the JAX package's), and the reference loads no part of the program."""

import json
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "agimus_controller_tpu"}


def loaded_after(code: str) -> set:
    """Top-level names of the modules loaded in a fresh interpreter that
    runs `code` from the benchmark's folder."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, "
            f"{str(BENCH.parent)!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_readers_and_reference_load_no_jax():
    code = """
import harness, traffic, tracing, roofline, metrics_context, control
import reference, reference.check, reference.fddp
import json as _j
b = _j.load(open('BENCHMARK.json'))
for m in b['end_to_end'] + b['per_layer']:
    harness.reader(m['name'])
cell = harness.load_cell(b['workloads'][0]['name'])
harness.build_problem(cell, 'cpu', horizon=2)
import agimus_controller_tpu_torch.solver.sqp_batch
import agimus_controller_tpu_torch.solver.fddp_batch
"""
    names = loaded_after(code)
    assert "agimus_controller_tpu_torch" in names  # the port is compared whole
    assert not names & FORBIDDEN


def test_reference_loads_no_part_of_the_program():
    names = loaded_after("import reference, reference.check, reference.ocp, "
                         "reference.fddp")
    assert not names & (FORBIDDEN | {"agimus_controller_tpu_torch"})


def test_harness_flags_a_forbidden_module(monkeypatch):
    import harness

    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert harness.forbidden_modules() == ["jaxlib"]
    monkeypatch.delitem(sys.modules, "jaxlib.fake")
    monkeypatch.setitem(sys.modules, "agimus_controller_tpu_torch_x", object())
    assert harness.forbidden_modules() == []
