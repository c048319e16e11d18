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


@pytest.mark.parametrize("module", [
    "models.tiago_pro", "ocp.ff_costs", "ops.lie", "ops.soft_contact"])
def test_slice12_module_is_probed(module):
    """The modules of soft contact, the quaternion free-flyer and the
    Tiago-Pro robot are among the modules probed above."""
    assert f"{PKG}.{module}" in MODULES


@pytest.mark.parametrize("package, name", [
    ("models", "load_tiago_pro"), ("models", "TIAGO_PRO_Q_READY"),
    ("models", "TIAGO_PRO_LEFT_ARM_JOINTS"),
    ("ops", "SoftContactConfig"), ("ops", "soft_contact_step"),
    ("ocp", "build_ff_cost_functions"), ("ocp", "FF_COST_KINDS"),
    ("ocp", "build_cost_functions"), ("solver", "solve_fddp"),
    ("solver", "SolverSettings"), ("solver", "CSQPSettings"),
    ("solver", "solve_csqp")])
def test_public_names_are_exported(import_results, package, name):
    """The sub-packages export the slice's public names, as the JAX
    package's `__init__`s do; the import probe above covers them."""
    import importlib

    assert import_results[f"{PKG}.{package}"] == "ok"
    assert hasattr(importlib.import_module(f"{PKG}.{package}"), name)


@pytest.mark.parametrize("module", [
    "parallel", "parallel.sensitivity", "plots", "plots.dump_utils",
    "plots.mpc_utils", "plots.pin_utils", "plots.plots_utils",
    "runtime.bag_readers", "runtime.checkpoint", "runtime.debugger",
    "runtime.meshcat_viz", "runtime.publisher", "runtime.recorder",
    "runtime.ros_shim", "solver.riccati_pscan"])
def test_io_and_sweep_module_is_probed(module):
    """The modules of the horizon-parallel Riccati, the runtime's I/O and
    debugging and the sensitivity sweep are among the modules probed
    above."""
    assert f"{PKG}.{module}" in MODULES


@pytest.mark.parametrize("package, name", [
    ("runtime", "MPCRecorder"), ("ocp", "make_timesteps"),
    ("parallel", "perturbed_params_batch"),
    ("parallel", "next_state_sensitivity"), ("parallel", "sensitivity_svd"),
    ("plots", "dump_plot_data"), ("plots", "get_p_"), ("plots", "get_rpy_"),
    ("plots", "get_u_grav"), ("plots", "get_v_"), ("plots", "get_w_"),
    ("plots", "plot_mpc_data"), ("plots", "plot_values")])
def test_io_and_sweep_names_are_exported(import_results, package, name):
    """The sub-packages export the JAX `__init__`s' names of these
    modules (`parallel` only the sensitivity sweep's for now)."""
    import importlib

    assert import_results[f"{PKG}.{package}"] == "ok"
    assert hasattr(importlib.import_module(f"{PKG}.{package}"), name)


def test_chip_smoke_imports_none_of_them():
    """`chip_smoke.py` imports nothing of JAX: it names neither `jax` nor
    the JAX package in an import."""
    import re

    src = (ROOT / "chip_smoke.py").read_text()
    assert not re.search(r"^\s*(from|import)\s+(jax|jaxlib|"
                         r"agimus_controller_tpu)\b", src, re.M)
