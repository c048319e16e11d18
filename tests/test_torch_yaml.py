"""The port's YAML OCP compiler vs the JAX package's, field by field.

Both shipped definitions (read from `agimus_controller_tpu/ocp/definitions/`),
a control-limit YAML written here and `chip_smoke.py`'s visual-servoing OCP
`VS_OCP` compile to equal specs, from a path, from text and from an
already-parsed tree; the package's copy of the collision-avoidance tree
(`ocp/definitions.py`), which lets the card's machine run without PyYAML,
equals `yaml.safe_load` of the file.
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.ocp.yaml_compiler import load_ocp_spec as jax_load_ocp_spec
from agimus_controller_tpu_torch.ocp import definitions
from agimus_controller_tpu_torch.ocp.yaml_compiler import load_ocp_spec
from tests._torch_csqp_cases import YAML as COLLISION_YAML
from tests.test_robot_models import ENV_URDF

GOAL_YAML = COLLISION_YAML.parent / "ocp_goal_reaching.yaml"
CONTROL_LIMIT_YAML = """
running_model:
  differential:
    costs:
    - name: ctrl
      weight: 0.5
      cost:
        activation: {class: ActivationModelWeightedQuad, weights: [1, 2, 3, 4, 5, 6, 7]}
        residual: {class: ResidualModelControl, uref: [0, 0, 0, 0, 0, 0, 0]}
    - name: hand
      update: true
      cost:
        residual: {class: ResidualModelFrameTranslation, frame_id: panda_hand_tcp}
    - name: elbow
      weight: 2.0
      active: false
      cost:
        activation: {class: ActivationModelExp, exponent: 1, alpha: 0.05}
        residual: {class: ResidualDistanceCollision, collision_pair_id: 0}
    constraints:
    - name: effort
      constraint: {class: ConstraintModelControlLimit}
    - name: band
      constraint:
        class: ConstraintModelResidual
        active_on_terminal_node: false
        lower: [-0.1, -0.2, 0.0]
        upper: [0.1, 0.2, 0.9]
        residual: {class: ResidualModelFrameTranslation, id: 3}
terminal_model:
  differential:
    costs:
    - name: ctrl
      cost:
        residual: {class: ResidualModelControl}
    - name: hand
      weight: 10
      cost:
        residual: {class: ResidualModelFrameRotation, frame_id: panda_hand_tcp}
"""
SOURCES = {"goal_reaching": GOAL_YAML, "collision": COLLISION_YAML,
           "control_limit": CONTROL_LIMIT_YAML,
           "visual_servoing": yaml.safe_dump(chip_smoke.VS_OCP)}


@pytest.fixture(scope="module")
def model():
    jm, _ = jax_load_panda(env_urdf=ENV_URDF, collision_pairs=[
        ("panda_link7_capsule", "obstacle_sphere")], dtype=np.float64)
    return jm


def _fields(spec):
    """A spec as plain data: every item as a dict, in order."""
    items = lambda seq: [dataclasses.asdict(i) for i in seq]
    return dict(running=items(spec.running_costs),
                terminal=items(spec.terminal_costs),
                constraints=items(spec.constraints), horizon=spec.horizon,
                dt=spec.dt, dt_factor_n_seq=tuple(spec.dt_factor_n_seq),
                soft_contact=spec.soft_contact)


@pytest.mark.parametrize("form", ["path", "text", "tree"])
@pytest.mark.parametrize("name", sorted(SOURCES))
def test_spec_matches_jax(model, name, form, tmp_path):
    src = SOURCES[name]
    if isinstance(src, str):  # the YAML written here goes through a file too
        text, path = src, tmp_path / "ocp.yaml"
        path.write_text(text)
    else:
        text, path = src.read_text(), src
    arg = {"path": path, "text": text, "tree": yaml.safe_load(text)}[form]
    kw = dict(horizon=7, dt=0.01, dt_factor_n_seq=((1, 5), (2, 2)),
              default_ee_frame="panda_hand_tcp")
    want = _fields(jax_load_ocp_spec(arg, model, **kw))
    got = _fields(load_ocp_spec(arg, model, **kw))
    assert got == want


def test_collision_tree_constant_matches_file():
    """The collision tree `chip_smoke.py` compiles is the package's copy of
    the shipped file (`ocp/definitions.py`)."""
    assert (definitions.TRAJ_TRACKING_COLLISION_AVOIDANCE
            == yaml.safe_load(COLLISION_YAML.read_text()))
    assert "COLLISION_OCP" not in vars(chip_smoke)


def test_collision_spec_from_constant(model):
    """The compiled tree: quad_exp collision costs (alpha 1e-4) in the
    running and terminal models and one 1 cm distance row on every node."""
    spec = load_ocp_spec(definitions.TRAJ_TRACKING_COLLISION_AVOIDANCE, model,
                         horizon=19, dt=0.01,
                         default_ee_frame="panda_hand_tcp")
    for items in (spec.running_costs, spec.terminal_costs):
        (coll,) = [i for i in items if i.kind == "collision_distance"]
        assert (coll.activation, coll.act_alpha, coll.update) == (
            "quad_exp", 1e-4, False)
    (con,) = spec.constraints
    assert (con.kind, con.lower, con.upper, con.terminal) == (
        "collision_distance", (0.01,), (float("inf"),), True)
    assert torch.isfinite(torch.tensor(spec.timesteps())).all()


def test_vs_spec_from_constant(model):
    """The compiled `VS_OCP`: the visual-servoing term on the hand with the
    `object` transform, and the static-weight velocity damping bound to the
    hand, local-world-aligned while running and local at the end."""
    spec = load_ocp_spec(chip_smoke.VS_OCP, model, horizon=19, dt=0.01,
                         default_ee_frame="panda_hand_tcp")
    for items, conv in ((spec.running_costs, "local_world_aligned"),
                        (spec.terminal_costs, "local")):
        (vs,) = [i for i in items if i.kind == "visual_servoing"]
        (vel,) = [i for i in items if i.kind == "frame_velocity"]
        assert (vs.frame, vs.object_frame, vs.update) == (
            "panda_hand_tcp", "object", True)
        assert (vel.frame, vel.reference_frame, vel.update) == (
            "panda_hand_tcp", conv, False)
        assert vel.act_weights == (1.0,) * 6
    assert [i.kind for i in spec.running_costs] == [
        "state", "control", "visual_servoing", "frame_velocity"]
    assert not spec.constraints
