"""K1-K5b on the card: each CUDA kernel vs its plain-PyTorch version, f32.

Marked `cuda`: skips without a CUDA device (a CUDA kernel has no CPU
mode; its math is held against the JAX package on the CPU by
`test_torch_stage.py` through the plain versions). The specs are
`chip_smoke.py`'s: the flagship goal tracking, the Pallas test spec without
("mixed") and with ("full") its collision item, the shipped
collision-avoidance YAML, the visual-servoing OCP ("vs"), the
visual-servoing + frame-velocity spec ("fv") and a spec with more ref
keys than the kernels' by-value table holds ("cap25"); the inputs keep the
collision, visual-servoing and frame-velocity terms live. K1/K2 also take
one dt for every node (a float, a 0-d tensor), K1-K4 the tick's ring-row
views of the refs. The step kernels K5a/K5b take random Panda nodes with v
and u live, with per-node and scalar dt. The nj = 2 instances run on a
planar 2-DoF arm (K3/K4 with every kind in the terminal model). On a GPU
machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use.) Tolerances are those of the Pallas kernels' tests.
"""

import numpy as np
import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.cuda

SIZES = (19, 100, 4096)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage kernels run only on the GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def panda(device):
    from agimus_controller_tpu_torch.models.panda import load_panda

    return load_panda(env_urdf=smoke.ENV_URDF, collision_pairs=smoke.PAIR,
                      dtype=torch.float32, device=device)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("kernel", [k[0] for k in smoke.STAGE_KERNELS])
@pytest.mark.parametrize("spec_name", ["flagship", "mixed", "full", "yaml",
                                       "vs", "fv", "cap25"])
def test_kernel_matches_plain(device, panda, spec_name, kernel, N):
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    _, kind, derivs, _ = next(k for k in smoke.STAGE_KERNELS if k[0] == kernel)
    refs, x, u, dt, t_idx = smoke.randomized_inputs(spec, model, N, seed=N,
                                                    device=device)
    if kind == "stage":
        k = make_cuda_stage(model, params, spec, derivs, device)
        got, want = k(x, u, dt, t_idx, refs), k.plain(x, u, dt, t_idx, refs)
        labels = smoke.STAGE_OUT if derivs else ("xnext", "l")
    else:
        k = make_cuda_terminal(model, params, spec, derivs, device)
        got, want = k(x, refs), k.plain(x, refs)
        labels = ("l", "lx", "lxx") if derivs else ("l",)
    torch.cuda.synchronize()
    assert k.launches == 1
    smoke.check_outputs(f"{kernel} {spec_name} N={N}", got, want, labels)


@pytest.mark.parametrize("kernel", ["K1_stage_derivs", "K2_stage_value"])
@pytest.mark.parametrize("spec_name", ["flagship", "full", "yaml", "vs", "fv"])
def test_stage_kernel_reads_tick_views(device, panda, spec_name, kernel):
    """K1/K2 on the tick's ring-row views of the refs (row stride = the ring
    width) give the outputs of the same refs held separately."""
    from agimus_controller_tpu_torch.ops.cuda_costs import make_cuda_stage

    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    derivs = kernel == "K1_stage_derivs"
    refs, x, u, dt, t_idx = smoke.randomized_inputs(spec, model, 19, seed=3,
                                                    device=device)
    views = smoke.tick_views(spec, model, refs)
    k = make_cuda_stage(model, params, spec, derivs, device)
    got, sep = k(x, u, dt, t_idx, views), k(x, u, dt, t_idx, refs)
    torch.cuda.synchronize()
    assert k.launches == 2
    smoke.check_outputs(f"{kernel} {spec_name} tick views", got,
                        k.plain(x, u, dt, t_idx, refs),
                        smoke.STAGE_OUT if derivs else ("xnext", "l"))
    assert all(torch.equal(a, b) for a, b in zip(got, sep))


@pytest.mark.parametrize("dt_form", ["float", "0-d"])
@pytest.mark.parametrize("kernel", ["K1_stage_derivs", "K2_stage_value"])
def test_stage_kernel_scalar_dt(device, panda, kernel, dt_form):
    """K1/K2 with one dt for every node, as a Python float or a 0-d tensor,
    agree with the plain version and give the outputs of the [N] dt."""
    from agimus_controller_tpu_torch.ops.cuda_costs import make_cuda_stage

    model, params = panda
    spec = smoke.SPECS["full"](100, model)
    derivs = kernel == "K1_stage_derivs"
    refs, x, u, _, t_idx = smoke.randomized_inputs(spec, model, 19, seed=6,
                                                   device=device)
    dt = 0.0125 if dt_form == "float" else torch.tensor(0.0125)
    k = make_cuda_stage(model, params, spec, derivs, device)
    got = k(x, u, dt, t_idx, refs)
    per_node = k(x, u, torch.full((19,), 0.0125, device=device), t_idx, refs)
    torch.cuda.synchronize()
    assert k.launches == 2
    smoke.check_outputs(f"{kernel} {dt_form} dt", got,
                        k.plain(x, u, dt, t_idx, refs),
                        smoke.STAGE_OUT if derivs else ("xnext", "l"))
    assert all(torch.equal(a, b) for a, b in zip(got, per_node))


@pytest.mark.parametrize("kernel", ["K3_terminal_derivs", "K4_terminal_value"])
@pytest.mark.parametrize("spec_name", ["flagship", "full", "yaml", "vs", "fv",
                                       "cap25"])
def test_terminal_kernel_reads_tick_views(device, panda, spec_name, kernel):
    """K3/K4 on the tick's ring-row views of the refs give the outputs of
    the same refs held separately, and agree with the plain version."""
    from agimus_controller_tpu_torch.ops.cuda_costs import make_cuda_terminal

    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    derivs = kernel == "K3_terminal_derivs"
    refs, x, _, _, _ = smoke.randomized_inputs(spec, model, 3, seed=8,
                                               device=device)
    views = smoke.tick_views(spec, model, refs)
    k = make_cuda_terminal(model, params, spec, derivs, device)
    got, sep = k(x, views), k(x, refs)
    torch.cuda.synchronize()
    assert k.launches == 2
    smoke.check_outputs(f"{kernel} {spec_name} tick views", got,
                        k.plain(x, refs), ("l", "lx", "lxx"))
    assert all(torch.equal(a, b) for a, b in zip(got, sep))


def test_wrapper_rejects_bad_inputs(device, panda):
    from agimus_controller_tpu_torch.ops.cuda_costs import make_cuda_stage

    model, params = panda
    spec = smoke.flagship_spec(100)
    refs, x, u, dt, t_idx = smoke.randomized_inputs(spec, model, 100, seed=0,
                                                    device=device)
    k = make_cuda_stage(model, params, spec, False, device)
    with pytest.raises(TypeError):
        k(x.double(), u, dt, t_idx, refs)
    with pytest.raises(ValueError):
        k(x.t().contiguous().t(), u, dt, t_idx, refs)
    with pytest.raises(ValueError):
        k(x, u[:50], dt, t_idx, refs)
    assert k.launches == 0


@pytest.mark.parametrize("dt_kind", ["per_node", "scalar"])
@pytest.mark.parametrize("N", (13, 4096))
@pytest.mark.parametrize("kernel", [k[0] for k in smoke.STEP_KERNELS])
def test_step_kernel_matches_plain(device, panda, kernel, N, dt_kind):
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    model, params = panda
    derivs = kernel == "K5b_step_derivs"
    x, u, dt = smoke.step_inputs(N, N, device, dt_kind)
    k = StepKernel(model, params, derivs, device)
    got, want = k(x, u, dt), k.plain(x, u, dt)
    torch.cuda.synchronize()
    assert k.launches == 1
    if not derivs:
        got, want = (got,), (want,)
    smoke.check_outputs(f"{kernel} N={N} {dt_kind} dt", got, want,
                        ("xnext", "Fx", "Fu")[:len(got)])


def test_step_wrapper_rejects_bad_inputs(device, panda):
    from agimus_controller_tpu_torch.ops.cuda_dynamics import make_cuda_step

    model, params = panda
    x, u, dt = smoke.step_inputs(64, 0, device, "per_node")
    k = make_cuda_step(model, params, device)
    with pytest.raises(TypeError):
        k(x.double(), u, dt)
    with pytest.raises(ValueError):
        k(x.t().contiguous().t(), u, dt)
    with pytest.raises(ValueError):
        k(x, u, dt[:10])
    with pytest.raises(ValueError):
        k(x, u.cpu(), dt)
    assert k.launches == 0


# the planar 2-DoF arm of tests/test_ring_control_loop.py (which imports JAX)
ARM_URDF = """<?xml version="1.0"?>
<robot name="planar2">
  <link name="base"><inertial><mass value="1"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.01" ixy="0" ixz="0" iyz="0"/></inertial></link>
  <joint name="j1" type="revolute"><parent link="base"/><child link="l1"/>
    <origin xyz="0 0 0.1" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit effort="50" lower="-3" upper="3" velocity="3"/></joint>
  <link name="l1"><inertial><origin xyz="0 0 0.15"/><mass value="1.5"/>
    <inertia ixx="0.02" iyy="0.02" izz="0.005" ixy="0" ixz="0" iyz="0"/></inertial></link>
  <joint name="j2" type="revolute"><parent link="l1"/><child link="l2"/>
    <origin xyz="0 0 0.3" rpy="0 0 0"/><axis xyz="0 1 0"/>
    <limit effort="50" lower="-3" upper="3" velocity="3"/></joint>
  <link name="l2"><inertial><origin xyz="0 0 0.12"/><mass value="0.8"/>
    <inertia ixx="0.01" iyy="0.01" izz="0.003" ixy="0" ixz="0" iyz="0"/></inertial></link>
  <joint name="jt" type="fixed"><parent link="l2"/><child link="tip"/>
    <origin xyz="0 0 0.25"/></joint>
  <link name="tip"/>
</robot>"""


@pytest.fixture(scope="module")
def arm(device):
    from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf

    return build_model_from_urdf(ARM_URDF, armature=np.array([0.1, 0.1]),
                                 dtype=torch.float32, device=device)


@pytest.mark.parametrize("kernel", [k[0] for k in smoke.STEP_KERNELS])
def test_step_kernel_2dof(device, arm, kernel):
    """nj = 2: K5a on 4 lanes a node, 32 nodes a block; K5b on 4 lanes."""
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    model, params = arm
    derivs = kernel == "K5b_step_derivs"
    rng = np.random.default_rng(6)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    N = 77
    x, u = f(rng.normal(size=(N, 4)) * 0.5), f(rng.normal(size=(N, 2)))
    dt = f(rng.uniform(0.005, 0.03, N))
    k = StepKernel(model, params, derivs, device)
    got, want = k(x, u, dt), k.plain(x, u, dt)
    torch.cuda.synchronize()
    if not derivs:
        got, want = (got,), (want,)
    smoke.check_outputs(f"{kernel} 2-DoF", got, want,
                        ("xnext", "Fx", "Fu")[:len(got)])


@pytest.mark.parametrize("kernel", ["K3_terminal_derivs", "K4_terminal_value"])
def test_terminal_kernel_2dof(device, arm, kernel):
    """nj = 2 (K3: 4 lanes a node) with every kind in the terminal model:
    the control items at u = 0, frame_velocity over all 2 NJ tangents."""
    from agimus_controller_tpu_torch.ocp.spec import (
        CostItem,
        ProblemSpec,
        default_references,
    )
    from agimus_controller_tpu_torch.ops.cuda_costs import make_cuda_terminal

    model, params = arm
    items = (
        CostItem(name="state_reg", kind="state", weight=0.5, update=True),
        CostItem(name="ctrl", kind="control", weight=0.05, update=True),
        CostItem(name="grav", kind="control_grav", weight=5e-3),
        CostItem(name="goal", kind="frame_placement", weight=50.0,
                 update=True, frame="tip"),
        CostItem(name="vel", kind="frame_velocity", weight=2.5, update=True,
                 frame="tip", reference_frame="local"))
    spec = ProblemSpec(running_costs=items, terminal_costs=items, horizon=8,
                       dt=0.01)
    rng = np.random.default_rng(3)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    refs = default_references(spec, model, device=device)
    for key, val in refs.items():
        if key != "ee_rot:tip":
            refs[key] = f(rng.uniform(0.1, 1.0, tuple(val.shape)))
    x = f(rng.normal(size=(45, 4)) * 0.5)
    k = make_cuda_terminal(model, params, spec,
                           kernel == "K3_terminal_derivs", device)
    got, want = k(x, refs), k.plain(x, refs)
    torch.cuda.synchronize()
    smoke.check_outputs(f"{kernel} 2-DoF", got, want, ("l", "lx", "lxx"))


@pytest.mark.parametrize("route", ["pack", "cost_functions"])
def test_xla_backend_launches_step_kernels_only(device, panda, route):
    """The "xla" backend of the batch SQP on a spec the stage kernels
    decline (`chip_smoke.keep_away_spec` at T=19, the goal and keep-away
    refs of phase 5): K5a/K5b launch, no stage kernel is built, and three
    SQP iterations give the iterations and, to 1e-2 on controls of order
    10-100, the controls of the same solve on the CPU (plain versions,
    f32)."""
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    model, params = panda
    posture = smoke.avoided_posture() if route == "cost_functions" else None
    spec = smoke.keep_away_spec(19, posture)
    x0 = torch.cat([torch.as_tensor(np.asarray(PANDA_Q_READY),
                                    dtype=torch.float32), torch.zeros(7)])
    sols = {}
    for dev in (device, torch.device("cpu")):
        p = type(params)(*(t.to(dev) for t in params))
        refs = smoke.keep_away_refs(spec, model, dev)
        solver = make_batch_sqp(model, p, spec, CSQPSettings(max_iters=3),
                                device=dev)
        assert solver.backend == "xla" and not hasattr(solver, "stage_dk")
        xs = x0.to(dev).expand(1, 20, 14).contiguous()
        us = torch.zeros((1, 19, 7), device=dev)
        sols[dev.type] = solver(x0.to(dev)[None], refs, xs, us)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert [k.launches > 0 for k in solver.kernels] == [True, True]
    g, w = sols["cuda"], sols["cpu"]
    assert bool(torch.isfinite(g.us).all())
    assert torch.equal(g.iters.cpu(), w.iters)
    np.testing.assert_allclose(g.us.cpu().numpy(), w.us.numpy(), rtol=0,
                               atol=1e-2)


def test_auto_keeps_checked_specs_on_the_kernels(device, panda):
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    model, params = panda
    for name in smoke.CHECKED_SPECS:
        spec = smoke.SPECS[name](100, model)
        solver = make_batch_sqp(model, params, spec, CSQPSettings(),
                                device=device)
        assert solver.backend == "kernels", (name, solver.backend_reason)
        assert len(solver.kernels) == 4
