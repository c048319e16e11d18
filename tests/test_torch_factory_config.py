"""The port's registries, shipped OCP definitions and engine config loader
vs the JAX package.

- every OCP registry entry builds the spec the JAX entry builds (items,
  constraints, horizon, timesteps), on the Panda with an obstacle pair;
  "goal_reaching_yaml" and "traj_tracking_collision_avoidance" from
  `ocp/definitions.py`'s trees, "yaml" from a file and from text;
- every warm-start entry (the force-feedback one on a soft contact);
- `ocp/definitions.py` equals `yaml.safe_load` of the JAX package's two
  shipped files;
- `load_engine_config` on an inline generate_parameter_library schema, a
  values text and a dict, field for field against the JAX loader, and the
  horizon and `n_threads` errors.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from agimus_controller_tpu.factory import create_ocp as jax_create_ocp
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.mpc.ocp_base import OCPParams as JaxParams
from agimus_controller_tpu.runtime.config import load_engine_config as jax_load_config
from agimus_controller_tpu_torch.factory import (
    OCP_REGISTRY,
    WARM_START_REGISTRY,
    create_ocp,
    create_warm_start,
)
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch
from agimus_controller_tpu_torch.mpc.warm_start import (
    WarmStartReference,
    WarmStartShiftPreviousSolution,
)
from agimus_controller_tpu_torch.ocp import definitions
from agimus_controller_tpu_torch.ocp.goal_reaching import OCPGoalReaching
from agimus_controller_tpu_torch.runtime.config import EngineConfig, load_engine_config
from tests.test_factory_config import VALUES_YAML
from tests.test_robot_models import ENV_URDF

DEFINITIONS = (Path(__file__).resolve().parent.parent / "agimus_controller_tpu"
               / "ocp" / "definitions")
PAIRS = [("panda_link7_capsule", "obstacle_sphere")]


@pytest.fixture(scope="module")
def panda():
    return (jax_load_panda(env_urdf=ENV_URDF, collision_pairs=PAIRS,
                           dtype=np.float64),
            load_panda(env_urdf=ENV_URDF, collision_pairs=PAIRS,
                       dtype=torch.float64, device="cpu"))


def _spec_fields(spec):
    """A spec as plain values (the packages' items are different classes)."""
    return {
        "running": [dataclasses.asdict(c) for c in spec.running_costs],
        "terminal": [dataclasses.asdict(c) for c in spec.terminal_costs],
        "constraints": [dataclasses.asdict(c) for c in spec.constraints],
        "horizon": spec.horizon, "dt": spec.dt,
        "timesteps": list(spec.timesteps()),
    }


@pytest.mark.parametrize("name, kw", [
    ("goal_reaching", {}),
    ("goal_reaching_yaml", {}),
    ("traj_tracking_collision_avoidance", {}),
    ("yaml", {"yaml_file": DEFINITIONS / "ocp_goal_reaching.yaml"}),
    ("yaml", {"yaml_file": (DEFINITIONS / "ocp_traj_tracking_collision_"
                            "avoidance.yaml").read_text()}),
], ids=["goal_reaching", "goal_reaching_yaml",
        "traj_tracking_collision_avoidance", "yaml_path", "yaml_text"])
def test_ocp_entry_matches_jax(panda, name, kw):
    (jm, jp), (pm, pp) = panda
    op = dict(dt=0.02, horizon_size=4, dt_factor_n_seq=((1, 2), (2, 2)))
    jocp = jax_create_ocp(name, jm, jp, JaxParams(**op),
                          ee_frame="panda_hand_tcp", dtype=jnp.float64, **kw)
    pocp = create_ocp(name, pm, pp, OCPParams(**op), ee_frame="panda_hand_tcp",
                      dtype=torch.float64, device="cpu", **kw)
    assert isinstance(pocp, OCPTorch)
    assert isinstance(pocp, OCPGoalReaching) == (name == "goal_reaching")
    assert _spec_fields(pocp.spec) == _spec_fields(jocp.spec)
    assert (pocp.n_controls, pocp.dt) == (jocp.n_controls, jocp.dt)
    assert pocp.solver_kind == "sqp"
    assert pocp.solver.backend == "kernels"


def test_ocp_registry_names_and_errors(panda):
    _, (pm, pp) = panda
    assert sorted(OCP_REGISTRY) == sorted(
        ["goal_reaching", "yaml", "goal_reaching_yaml",
         "traj_tracking_collision_avoidance"])
    with pytest.raises(KeyError, match="unknown OCP"):
        create_ocp("nope", pm, pp, OCPParams(), device="cpu")


def test_warm_start_entries(panda):
    _, (pm, pp) = panda
    assert sorted(WARM_START_REGISTRY) == sorted(
        ["reference", "shift_previous_solution",
         "shift_previous_solution_force_feedback"])
    assert isinstance(create_warm_start("reference", pm, pp, device="cpu"),
                      WarmStartReference)
    ws = create_warm_start("shift_previous_solution", pm, pp,
                           timesteps=np.full(5, 0.01), device="cpu")
    assert isinstance(ws, WarmStartShiftPreviousSolution)
    # the force-feedback warm start sets up on a soft contact and shifts
    # the force-augmented state
    from agimus_controller_tpu_torch.mpc.warm_start import (
        WarmStartShiftPreviousSolutionForceFeedback,
    )
    from agimus_controller_tpu_torch.ops.soft_contact import SoftContactConfig

    ws_ff = create_warm_start(
        "shift_previous_solution_force_feedback", pm, pp,
        timesteps=np.full(5, 0.01), soft_contact=SoftContactConfig(
            frame="panda_hand_tcp"), device="cpu")
    assert isinstance(ws_ff, WarmStartShiftPreviousSolutionForceFeedback)
    with pytest.raises(KeyError, match="unknown"):
        create_warm_start("nope", pm, pp)


@pytest.mark.parametrize("name, tree", [
    ("ocp_goal_reaching.yaml", definitions.GOAL_REACHING),
    ("ocp_traj_tracking_collision_avoidance.yaml",
     definitions.TRAJ_TRACKING_COLLISION_AVOIDANCE),
])
def test_definitions_equal_shipped_files(name, tree):
    assert tree == yaml.safe_load((DEFINITIONS / name).read_text())


# a generate_parameter_library schema in the reference's layout (leaves
# {type, default_value, ...}), a few of its parameters
SCHEMA_YAML = """
agimus_controller_params:
  rate:
    type: double
    default_value: 100.0
    description: "Rate of the control loop"
  constant_delay:
    type: bool
    default_value: false
  publish_debug_data:
    type: bool
    default_value: true
  free_flyer:
    type: bool
    default_value: false
  collision_pairs_names:
    type: string_array
    default_value: [""]
  moving_geometries_names:
    type: string_array
  ocp:
    dt:
      type: double
      default_value: 0.01
    horizon_size:
      type: int
      default_value: 19
    dt_factor_n_seq:
      factors:
        type: int_array
        default_value: [1]
      n_steps:
        type: int_array
        default_value: [19]
    armature:
      type: double_array
      default_value: [0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1]
    max_iter:
      type: int
      default_value: 10
    max_qp_iter:
      type: int
      default_value: 100
    max_solve_time:
      type: double
      default_value: 0.1
    termination_tolerance:
      type: double
      default_value: 1e-3
    n_threads:
      type: int
      default_value: 1
    definition_yaml_file:
      type: string
      default_value: ""
"""


def _config_fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    out["ocp"] = dataclasses.asdict(cfg.ocp)
    out["runtime"] = dataclasses.asdict(cfg.runtime)
    out["armature"] = list(cfg.armature)
    return out


@pytest.mark.parametrize("source", ["schema", "values", "values_dict"])
def test_load_engine_config_matches_jax(source):
    text = SCHEMA_YAML if source == "schema" else VALUES_YAML
    arg = yaml.safe_load(text) if source == "values_dict" else text
    cfg = load_engine_config(arg)
    assert isinstance(cfg, EngineConfig)
    assert _config_fields(cfg) == _config_fields(jax_load_config(arg))
    if source == "schema":
        assert cfg.ocp.horizon_size == 19
        assert cfg.ocp.dt_factor_n_seq == ((1, 19),)
        assert cfg.runtime.rate == 100.0
    else:
        assert cfg.ocp.dt_factor_n_seq == ((1, 30), (2, 20), (4, 10))
        assert cfg.collision_pairs == PAIRS


@pytest.mark.parametrize("old, new, match", [
    ("horizon_size: 60", "horizon_size: 61", "horizon_size"),
    ("n_threads: 8", "n_threads: 0", "n_threads"),
    ("n_steps: [30, 20, 10]", "n_steps: [30, 0, 10]", "dt_factor_n_seq"),
])
def test_load_engine_config_errors(old, new, match):
    bad = VALUES_YAML.replace(old, new)
    assert bad != VALUES_YAML
    with pytest.raises(ValueError, match=match):
        load_engine_config(bad)
    with pytest.raises(ValueError, match=match):
        jax_load_config(bad)
