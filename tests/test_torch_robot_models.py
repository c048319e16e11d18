"""The port's model factory and xacro expansion vs the JAX package, f64.

- `RobotModelParameters` / `build_robot_models`: the full and the reduced
  Panda, with an environment URDF grafted on `panda_link0` and the SRDF's
  self-collision pairs, equal to the JAX package's (topology equal, every
  parameter at 1e-12); a reduced model with a locked joint; the
  `__post_init__` errors, word for word.
- `expand_xacro`: the cases of `test_xacro.py` through the port, the
  expanded text identical to the JAX package's, and a raw `.xacro`
  environment through the port's `build_model_from_urdf` equal to the
  expanded one and to the JAX model.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from agimus_controller_tpu.models import urdf as jurdf
from agimus_controller_tpu.models.panda import PANDA_SRDF as JAX_SRDF
from agimus_controller_tpu.models.xacro import expand_xacro as jax_expand
from agimus_controller_tpu_torch.models.panda import (
    PANDA_DEFAULT_ARMATURE,
    PANDA_SRDF,
    PANDA_URDF,
)
from agimus_controller_tpu_torch.models.urdf import (
    RobotModelParameters,
    RobotModels,
    build_model_from_urdf,
    build_robot_models,
)
from agimus_controller_tpu_torch.models.xacro import expand_xacro
from tests.test_robot_models import ENV_URDF
from tests.test_xacro import ENV_XACRO

JOINTS = [f"panda_joint{i}" for i in range(1, 8)]
PAIRS = [("panda_link7_capsule", "obstacle_sphere")]


def _topology(model):
    """The static topology as plain values (the packages' `Frame` and
    `Geometry` are different classes with the same fields)."""
    plain = lambda v: (dataclasses.asdict(v) if dataclasses.is_dataclass(v)  # noqa: E731
                       else v)
    return {k: tuple(plain(e) for e in v) if isinstance(v, tuple) else v
            for k, v in vars(model).items()}


def _assert_same_model(pm, pp, jm, jp, atol=1e-12):
    assert _topology(pm) == _topology(jm)
    for name in type(pp)._fields:
        np.testing.assert_allclose(getattr(pp, name).numpy(),
                                   np.asarray(getattr(jp, name)), rtol=0,
                                   atol=atol, err_msg=name)


def _both(**kw):
    """(port RobotModels, JAX RobotModels) of the same parameters."""
    port = build_robot_models(RobotModelParameters(dtype=torch.float64, **kw),
                              device="cpu")
    jax = jurdf.build_robot_models(jurdf.RobotModelParameters(
        dtype=np.float64, **kw))
    return port, jax


@pytest.mark.parametrize("moving", [JOINTS, JOINTS[:2] + JOINTS[3:]],
                         ids=["all_joints", "joint3_locked"])
def test_robot_models_match_jax(moving):
    q0 = np.array([0.3, -0.5, 0.2, -2.0, 0.1, 1.5, 0.4])
    port, jax = _both(
        robot_urdf=PANDA_URDF, q0=q0, moving_joint_names=list(moving),
        armature=np.full(len(moving), 0.1), env_urdf=ENV_URDF,
        robot_attachment_frame="panda_link0", srdf=PANDA_SRDF,
        collision_as_capsule=True, collision_pairs=PAIRS, self_collision=True)
    assert isinstance(port, RobotModels)
    _assert_same_model(port.full_model, port.full_params, jax.full_model,
                       jax.full_params)
    _assert_same_model(port.robot_model, port.params, jax.robot_model,
                       jax.params)
    np.testing.assert_allclose(port.armature.numpy(),
                               np.asarray(jax.armature), rtol=0, atol=0)
    assert port.robot_model.nq == len(moving) and port.full_model.nq == 7
    assert len(port.robot_model.collision_pairs) > 1  # SRDF pairs + PAIRS
    assert port.params.mass.dtype == torch.float64


def test_srdf_constants_equal():
    assert PANDA_SRDF == JAX_SRDF


@pytest.mark.parametrize("kw, match", [
    (dict(robot_urdf=""), "Robot URDF can not be an empty string."),
    (dict(robot_urdf=Path("/nonexistent/robot.urdf")),
     "Robot URDF file '/nonexistent/robot.urdf' doesn't exist!"),
    (dict(robot_urdf=PANDA_URDF, env_urdf=Path("/nonexistent/env.urdf")),
     "Environment URDF file '/nonexistent/env.urdf' doesn't exist!"),
    (dict(robot_urdf=PANDA_URDF, srdf=Path("/nonexistent/robot.srdf")),
     "SRDF file '/nonexistent/robot.srdf' doesn't exist!"),
    (dict(robot_urdf=PANDA_URDF, moving_joint_names=["panda_joint1"],
          armature=np.zeros(3)),
     "Armature must have the same shape as moving_joint_names. "
     "Got (3,) and 1."),
], ids=["empty_urdf", "urdf_path", "env_path", "srdf_path", "armature"])
def test_parameters_validation_matches_jax(kw, match):
    with pytest.raises(ValueError) as port_err:
        RobotModelParameters(**kw)
    with pytest.raises(ValueError) as jax_err:
        jurdf.RobotModelParameters(**kw)
    assert str(port_err.value) == str(jax_err.value) == match


def test_parameters_default_armature():
    p = RobotModelParameters(robot_urdf=PANDA_URDF, moving_joint_names=JOINTS)
    np.testing.assert_array_equal(p.armature, np.zeros(7))
    assert p.dtype == torch.float32


MACRO_DOC = """<robot xmlns:xacro="http://www.ros.org/wiki/xacro" name="m">
  <xacro:macro name="pad" params="w h:=2.0">
    <link name="pad"><visual><geometry>
      <box size="${w} ${h} 0.1"/></geometry></visual></link>
  </xacro:macro>
  <xacro:pad w="1.5"/>
</robot>"""


@pytest.mark.parametrize("doc", [ENV_XACRO, MACRO_DOC], ids=["env", "macro"])
def test_expand_xacro_matches_jax(doc):
    out = expand_xacro(doc)
    assert out == jax_expand(doc)
    assert "xacro" not in out


def test_expand_xacro_strict_and_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        expand_xacro(ENV_XACRO, strict=True)  # include unresolvable
    path = tmp_path / "env.xacro"
    path.write_text(ENV_XACRO)
    assert expand_xacro(str(path)) == jax_expand(str(path))


def test_raw_xacro_environment_builds():
    """A raw `.xacro` environment drops into the port's model compiler (its
    `_read` expands it), equal to the expanded URDF and to the JAX model."""
    pairs = [("panda_link7_capsule", "obstacle1_capsule")]
    kw = dict(armature=PANDA_DEFAULT_ARMATURE,
              robot_attachment_frame="panda_link0", collision_as_capsule=True,
              collision_pairs=pairs)
    pm, pp = build_model_from_urdf(PANDA_URDF, env_urdf=ENV_XACRO,
                                   dtype=torch.float64, device="cpu", **kw)
    em, ep = build_model_from_urdf(PANDA_URDF, env_urdf=expand_xacro(ENV_XACRO),
                                   dtype=torch.float64, device="cpu", **kw)
    jm, jp = jurdf.build_model_from_urdf(PANDA_URDF, env_urdf=ENV_XACRO,
                                         dtype=np.float64, **kw)
    _assert_same_model(pm, pp, em, ep, atol=0)
    _assert_same_model(pm, pp, jm, jp)
    assert pm.geometry_id("obstacle1_capsule") >= 0
    assert len(pm.collision_pairs) == 1
