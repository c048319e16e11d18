"""The PyTorch port never imports JAX (nor the JAX package).

Every module of `agimus_controller_tpu_torch` is imported in one fresh
interpreter whose import system refuses `jax`, `jaxlib` and
`agimus_controller_tpu`; each module is one case.
"""

import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = "agimus_controller_tpu_torch"
MODULES = [PKG] + sorted(
    m.name for m in pkgutil.walk_packages([str(ROOT / PKG)], prefix=PKG + "."))

_PROBE = r"""
import importlib, importlib.abc, json, sys, traceback

BLOCKED = ("jax", "jaxlib", "agimus_controller_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name!r}")
        return None

sys.meta_path.insert(0, Block())
out = {}
for mod in json.loads(sys.argv[1]):
    try:
        importlib.import_module(mod)
        out[mod] = "ok"
    except Exception:
        out[mod] = traceback.format_exc()
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def import_results():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(MODULES)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_without_jax(import_results, module):
    assert import_results[module] == "ok", import_results[module]


@pytest.mark.parametrize("module", [
    "ocp.costs", "ocp.yaml_compiler", "ops.activations", "ops.collision",
    "ops.kinematics", "ops.residuals", "ops.spatial"])
def test_collision_path_module_is_probed(module):
    """The collision path's modules are among the modules probed above."""
    assert f"{PKG}.{module}" in MODULES


@pytest.mark.parametrize("module", [
    "device", "ops.dynamics", "trajectories", "trajectories.base",
    "trajectories.generic"])
def test_vs_path_module_is_probed(module):
    """The visual-servoing path's new modules are among the modules probed
    above."""
    assert f"{PKG}.{module}" in MODULES


@pytest.mark.parametrize("module", [
    "ops.batched_costs", "ops.cuda_dynamics", "solver.fddp",
    "solver.fddp_batch", "solver.riccati_components"])
def test_batch_path_module_is_probed(module):
    """The batch FDDP path's modules are among the modules probed above."""
    assert f"{PKG}.{module}" in MODULES


@pytest.mark.parametrize("module", [
    "ocp.costs", "ops.dynamics", "ops.integrator", "solver.csqp",
    "solver.fddp", "solver.sqp_batch"])
def test_single_scenario_module_is_probed(module):
    """The modules of the generic cost functions, the single-scenario
    solvers and the fallback backend are among the modules probed above."""
    assert f"{PKG}.{module}" in MODULES


@pytest.mark.parametrize("module", [
    "factory", "factory.registry", "models.xacro", "mpc.data", "mpc.mpc",
    "mpc.ocp_base", "mpc.warm_start", "ocp.definitions", "ocp.goal_reaching",
    "runtime", "runtime.config", "runtime.controller",
    "trajectories.sine_waves"])
def test_control_loop_module_is_probed(module):
    """The modules of the reference-shaped control loop (the model factory
    and xacro, the OCP facade, warm starts, MPC, the registries, the engine
    config, the controller runtime and the sine generators) are among the
    modules probed above."""
    assert f"{PKG}.{module}" in MODULES
