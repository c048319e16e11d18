"""Port models vs the JAX package: same topology, same `ModelParams`."""

import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu_torch.models.model import ModelParams, params_from_numpy
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
from tests.test_ring_control_loop import URDF_2DOF
from tests.test_robot_models import ENV_URDF

PAIR = [("panda_link7_capsule", "obstacle_sphere")]


def _build(name):
    if name == "panda_env":
        jm, jp = jax_load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                                dtype=np.float64)
        m, p = load_panda(env_urdf=ENV_URDF, collision_pairs=PAIR,
                          dtype=torch.float64, device="cpu")
    else:
        arm = np.array([0.1, 0.1])
        jm, jp = jax_build(URDF_2DOF, armature=arm, dtype=np.float64)
        m, p = build_model_from_urdf(URDF_2DOF, armature=arm,
                                     dtype=torch.float64, device="cpu")
    return jm, jp, m, p


MODELS = ("panda_env", "planar2")


@pytest.fixture(scope="module", params=MODELS)
def built(request):
    return _build(request.param)


def test_topology_equal(built):
    jm, _, m, _ = built
    for f in ("name", "joint_names", "joint_types", "parents",
              "collision_pairs"):
        assert getattr(m, f) == getattr(jm, f), f
    as_tuples = lambda seq: [tuple(vars(x).values()) for x in seq]
    assert as_tuples(m.frames) == as_tuples(jm.frames)
    assert as_tuples(m.geometries) == as_tuples(jm.geometries)
    assert (m.nj, m.nx) == (jm.nj, jm.nx)


@pytest.mark.parametrize("field", ModelParams._fields)
def test_params_field_equal(built, field):
    _, jp, _, p = built
    got = getattr(p, field)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jp, field)))


def test_params_from_numpy_round_trip(built):
    _, jp, _, p = built
    carried = params_from_numpy(jp, dtype=torch.float64, device="cpu")
    back = params_from_numpy(
        ModelParams(*(t.numpy() for t in carried)), dtype=torch.float64,
        device="cpu")
    for f in ModelParams._fields:
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      getattr(p, f).numpy())
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(p, f).numpy())
    f32 = params_from_numpy(jp, dtype=torch.float32, device="cpu")
    assert all(getattr(f32, f).dtype == torch.float32 for f in ModelParams._fields)


def test_xacro_not_ported():
    """The URDF reader expands xacro, as the JAX `_read` does: the 2-DoF
    arm written with a xacro property compiles to the plain URDF's model
    and params."""
    doc = URDF_2DOF.replace(
        '<robot name="planar2">',
        '<robot xmlns:xacro="http://www.ros.org/wiki/xacro" name="planar2">'
        '<xacro:property name="l2_len" value="0.3"/>').replace(
        '<origin xyz="0 0 0.3" rpy="0 0 0"/>',
        '<origin xyz="0 0 ${l2_len}" rpy="0 0 0"/>')
    assert "${l2_len}" in doc
    m, p = build_model_from_urdf(doc, dtype=torch.float64, device="cpu")
    m0, p0 = build_model_from_urdf(URDF_2DOF, dtype=torch.float64,
                                   device="cpu")
    assert m == m0
    for f in ModelParams._fields:
        np.testing.assert_array_equal(getattr(p, f).numpy(),
                                      getattr(p0, f).numpy())
