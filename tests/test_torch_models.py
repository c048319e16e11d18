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
                          dtype=torch.float64)
    else:
        arm = np.array([0.1, 0.1])
        jm, jp = jax_build(URDF_2DOF, armature=arm, dtype=np.float64)
        m, p = build_model_from_urdf(URDF_2DOF, armature=arm,
                                     dtype=torch.float64)
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
    carried = params_from_numpy(jp, dtype=torch.float64)
    back = params_from_numpy(
        ModelParams(*(t.numpy() for t in carried)), dtype=torch.float64)
    for f in ModelParams._fields:
        np.testing.assert_array_equal(getattr(carried, f).numpy(),
                                      getattr(p, f).numpy())
        np.testing.assert_array_equal(getattr(back, f).numpy(),
                                      getattr(p, f).numpy())
    f32 = params_from_numpy(jp, dtype=torch.float32)
    assert all(getattr(f32, f).dtype == torch.float32 for f in ModelParams._fields)


def test_xacro_not_ported():
    with pytest.raises(NotImplementedError):
        build_model_from_urdf(
            '<robot xmlns:xacro="http://www.ros.org/wiki/xacro" name="r"/>')
