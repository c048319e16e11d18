"""The dynamics-step kernels K5a/K5b's per-lane programs on the CPU, f32.

K5a and K5b run a node on LANES lanes (`csrc/step_kernels.cu`), in phases
separated by warp barriers whose per-lane steps are the host/device
functions `ag::k5_*` of `csrc/stage_kernels.cuh`. This test builds them with
g++ into a host library (`tests/stage_lanes_harness.cpp`, which runs each
phase lane by lane over a NaN-filled scratch), feeds it the wrapper's
packed model constants, and holds K5b's x+, Fx and Fu and K5a's x+ at
`chip_smoke.TOL` against `StepKernel.plain`, against the JAX package's
`make_batched_step_with_derivs` / `make_batched_step` in f32 (the Pallas
kernel body on the tree, which the batched step does not take; at nj = 17
the plain version stands for it, held against that body in f64 by
`test_torch_joint_counts.py`: the body runs eagerly for ~15 s there), and
against
the one-thread body `ag::dynamics_node` that both ran before, on the Panda
(16 lanes per K5b node, 8 per K5a node), the 8-joint Tiago-Pro arm (16
lanes per K5b and K5a node, none spare in K5b; a prismatic root joint), the
full 17-DoF Tiago-Pro (branched: the head and both arms on the torso; 32
lanes per K5b node, lanes 0-1 two tangents each, 32 per K5a node), the
2-DoF arm (4 lanes) and a 2-DoF tree with a prismatic joint (the kernels'
path for a tree that is no serial chain), with per-node and scalar dt,
nodes drawn from a numpy seed. The harness is built per joint count, as
the kernels are (`tests/_torch_lanes_lib.py`).
K5a's x+ also equals K5b's bit for bit (the same primal phases). Skips only
without g++.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.models.tiago_pro import (
    load_tiago_pro as jax_load_tiago_pro,
)
from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.ops.batched_dynamics import _StaticModel as JaxStaticModel
from agimus_controller_tpu.ops.batched_dynamics import (
    make_batched_step,
    make_batched_step_with_derivs,
)
from agimus_controller_tpu.ops.pallas_dynamics import (
    dynamics_terms as jax_dynamics_terms,
)
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.models.tiago_pro import TIAGO_PRO_Q_READY
from agimus_controller_tpu_torch.ops.cuda_dynamics import (
    StepKernel,
    _pack_model,
    dt_per_node,
)
from tests.test_ring_control_loop import URDF_2DOF
from tests.test_torch_stage_lanes import host_lib  # noqa: F401 (fixture)

CPU = torch.device("cpu")
N = 37
OUT = ("xnext", "Fx", "Fu")
# the 2-DoF arm with its second joint prismatic and on the base: a tree
# that is no serial chain, through the kernel's general-tree path
URDF_FORK = URDF_2DOF.replace(
    '<joint name="j2" type="revolute"><parent link="l1"/>',
    '<joint name="j2" type="prismatic"><parent link="base"/>').replace(
    '<origin xyz="0 0 0.3" rpy="0 0 0"/><axis xyz="0 1 0"/>',
    '<origin xyz="0.2 0 0.1" rpy="0.3 0 0"/><axis xyz="0 0 1"/>')


@pytest.fixture(scope="module",
                params=["panda", "tiago", "tiago17", "arm", "fork"])
def robot(request):
    if request.param == "panda":
        jm, jp = jax_load_panda(dtype=np.float32)
    elif request.param == "tiago":
        jm, jp = jax_load_tiago_pro(dtype=np.float32)
    elif request.param == "tiago17":
        jm, jp = jax_load_tiago_pro(moving_joint_names="all",
                                    dtype=np.float32)
    else:
        urdf = URDF_2DOF if request.param == "arm" else URDF_FORK
        jm, jp = jax_build(urdf, armature=np.array([0.1, 0.1]),
                           dtype=np.float32)
        assert (tuple(jm.parents) == (-1, -1)) == (request.param == "fork")
    return request.param, jm, jp, params_from_numpy(
        jp, dtype=torch.float32, device=CPU)


def nodes(name, nj, dt_kind):
    if name == "panda":
        return smoke.step_inputs(N, 11, CPU, dt_kind)
    if name == "tiago":
        return smoke.step_inputs(N, 11, CPU, dt_kind, TIAGO_PRO_Q_READY)
    if name == "tiago17":
        return smoke.step_inputs(N, 11, CPU, dt_kind, smoke.tiago_full_ready())
    rng = np.random.default_rng(12)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32)
    x = f(rng.normal(size=(N, 2 * nj)) * 0.5)
    u = f(rng.normal(size=(N, nj)))
    dt = f(rng.uniform(0.005, 0.03, N)) if dt_kind == "per_node" else 0.01
    return x, u, dt


def run_host(lib, model, params, x, u, dt, lanes, derivs=True):
    """K5b (derivs) or K5a through the host harness: (x+, Fx, Fu), or
    (x+,) for K5a; lanes = 1 runs the one-thread body."""
    nj = model.nj
    consts = torch.as_tensor(_pack_model(model, params).astype(np.float32))
    dt = dt_per_node(dt, x)
    outs = tuple(torch.full(s, float("nan")) for s in
                 ((N, 2 * nj), (N, 2 * nj, 2 * nj), (N, 2 * nj, nj)))
    assert lib.ag_step_host(
        nj, int(derivs), lanes, N, x.data_ptr(), u.data_ptr(), dt.data_ptr(),
        consts.data_ptr(), *(o.data_ptr() for o in outs)) == 0
    return outs if derivs else outs[:1]


def jax_step(jm, jp, x, u, dt, derivs=True):
    """The JAX package's step, with derivatives or without, f32: the
    batched XLA step on a serial chain (its scan form takes chains only),
    else the Pallas kernel body on component arrays."""
    jdt = jnp.asarray(dt if not isinstance(dt, torch.Tensor) else dt.numpy())
    if tuple(jm.parents) == tuple(range(-1, jm.nj - 1)):
        make = make_batched_step_with_derivs if derivs else make_batched_step
        out = make(jm, jp)(jnp.asarray(x.numpy()), jnp.asarray(u.numpy()), jdt)
        return tuple(torch.as_tensor(np.array(a)) for a in
                     (out if derivs else (out,)))
    nj = jm.nj
    comps = lambda a: [jnp.asarray(a[:, i].numpy()[None]) for i in
                       range(a.shape[1])]
    xn, fx, fu = jax_dynamics_terms(
        JaxStaticModel(jm, jp), comps(x[:, :nj]), comps(x[:, nj:]), comps(u),
        jnp.broadcast_to(jdt, (N,))[None].astype(jnp.float32), derivs)
    rows = lambda cs: torch.as_tensor(np.stack(
        [np.broadcast_to(np.asarray(c)[0], (N,)) for c in cs], 1))
    if not derivs:
        return (rows(xn),)
    return (rows(xn), rows(fx).reshape(N, 2 * nj, 2 * nj),
            rows(fu).reshape(N, 2 * nj, nj))


@pytest.mark.parametrize("dt_kind", ["per_node", "scalar"])
def test_step_lanes_match_references(host_lib, robot, dt_kind):
    name, jm, jp, params = robot
    x, u, dt = nodes(name, jm.nj, dt_kind)
    got = run_host(host_lib, jm, params, x, u, dt, lanes=0)
    plain = StepKernel(jm, params, True, CPU).plain(x, u, dt)
    one_thread = run_host(host_lib, jm, params, x, u, dt, lanes=1)
    refs = [("plain", plain), ("one-thread body", one_thread)]
    if name != "tiago17":
        refs.append(("jax", jax_step(jm, jp, x, u, dt)))
    for ref, want in refs:
        smoke.check_outputs(f"K5b lanes {name} {dt_kind} dt vs {ref}", got,
                            want, OUT)


@pytest.mark.parametrize("dt_kind", ["per_node", "scalar"])
def test_step_a_lanes_match_references(host_lib, robot, dt_kind):
    """K5a: placements one a lane, the mass-matrix columns beside the bias,
    the factor, solve and x+ on lane 0."""
    name, jm, jp, params = robot
    x, u, dt = nodes(name, jm.nj, dt_kind)
    got = run_host(host_lib, jm, params, x, u, dt, lanes=0, derivs=False)
    plain = (StepKernel(jm, params, False, CPU).plain(x, u, dt),)
    one_thread = run_host(host_lib, jm, params, x, u, dt, lanes=1,
                          derivs=False)
    refs = [("plain", plain), ("one-thread body", one_thread)]
    if name != "tiago17":
        refs.append(("jax", jax_step(jm, jp, x, u, dt, derivs=False)))
    for ref, want in refs:
        smoke.check_outputs(f"K5a lanes {name} {dt_kind} dt vs {ref}", got,
                            want, OUT[:1])
    k5b = run_host(host_lib, jm, params, x, u, dt, lanes=0)
    assert torch.equal(got[0], k5b[0])
