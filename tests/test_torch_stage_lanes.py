"""The stage and terminal kernels' per-lane programs on the CPU, against
the plain versions, f32.

K1 splits a node across LANES lanes (phases separated by warp barriers),
K2 across two warps (`csrc/stage_kernels.cu`), and K3/K4 run a node on a
warp that gathers its ref row (`csrc/terminal_kernels.cu`; K4 one cost
item a lane); their per-lane steps are host/device functions of
`csrc/stage_kernels.cuh`. This test builds them with g++ into a host
library (`tests/stage_lanes_harness.cpp`, which runs each phase lane by
lane and K2's two warps one after the other), feeds it the wrapper's own
source table (`RefPlan.table`), dt (`dt_per_node`) and packed constants,
and holds every output against `StageKernel.plain` / `TerminalKernel.plain`
at `chip_smoke.TOL`, on chip_smoke's flagship, `full`, `yaml`, `vs`, `fv`
and `cap25` (more ref keys than the by-value table holds) specs at N = 19
(ragged against the kernels' 8 and 32 nodes per block), with the refs as
`default_references` holds them and as the tick's ring-row views; K1/K2
with one dt for every node, as a float and as a 0-d tensor; on the 2-DoF
arm (4 lanes per node); and on the 8-joint Tiago-Pro arm (`chip_smoke.
tiago_spec`, 16 lanes per node and none spare, a prismatic root joint) at
the node counts phase 7 launches K1/K2 at, K3/K4 at one node; and at other
joint counts: the full 17-DoF branched Tiago-Pro with the bimanual
`chip_smoke.tiago_full_spec` (32 lanes per node, tangents strided: lanes 0-1
take two), a 4-joint Tiago-Pro chain and the 2-joint fork (a prismatic
joint on the base). The harness is built per joint count, as the kernels
are (`tests/_torch_lanes_lib.py`). Skips only without g++.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import chip_smoke as smoke
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.models.tiago_pro import load_tiago_pro
from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
from agimus_controller_tpu_torch.ocp.spec import (
    CostItem,
    ProblemSpec,
    default_references,
)
from agimus_controller_tpu_torch.ops import cuda_costs
from agimus_controller_tpu_torch.ops.cuda_dynamics import dt_per_node
from tests._torch_lanes_lib import HostLibs
from tests.test_ring_control_loop import URDF_2DOF

CPU = torch.device("cpu")
N = 19
SPECS = ("flagship", "full", "yaml", "vs", "fv", "cap25")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The harness, built with g++ per joint count at the count's first use
    (`tests/_torch_lanes_lib.py`)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernels' per-lane functions")
    return HostLibs(tmp_path_factory.mktemp("stage_lanes"))


@pytest.fixture(scope="module")
def panda():
    return load_panda(env_urdf=smoke.ENV_URDF, collision_pairs=smoke.PAIR,
                      dtype=torch.float32, device=CPU)


def run_host(lib, k, x, u, dt, t_idx, refs):
    """The wrapper's launch, through the host harness."""
    nj, n = k.nj, x.shape[0]
    nx = 2 * nj
    tab, keep = k.plan.table(refs, CPU)
    consts = torch.as_tensor(cuda_costs._pack_constants(
        k.model, k.params, k.items, k.offsets))
    dt = dt_per_node(dt, x)
    new = lambda *s: torch.full((n,) + s, float("nan"))
    if k.derivs:
        outs = (new(nx), new(nx, nx), new(nx, nj), new(), new(nx), new(nj),
                new(nx, nx), new(nx, nj), new(nj, nj))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs = (new(nx), new())
        ptrs = [outs[0].data_ptr(), None, None, outs[1].data_ptr()] + [None] * 5
    t_idx = t_idx.to(torch.long).contiguous()
    err = lib.ag_stage_host(
        nj, int(k.derivs), n, x.data_ptr(), u.data_ptr(), dt.data_ptr(),
        t_idx.data_ptr(), ctypes.addressof(tab), k.width, consts.data_ptr(),
        consts.numel(), len(k.items), *ptrs)
    assert err == 0
    del keep
    return outs


def run_terminal_host(lib, k, x, refs, one_thread=False):
    """The terminal wrapper's launch, through the host harness; with
    one_thread, K3's one-thread body `terminal_node` in place of its lane
    program."""
    n, nx = x.shape[0], 2 * k.nj
    tab, keep = k.plan.table(refs, CPU)
    consts = torch.as_tensor(cuda_costs._pack_constants(
        k.model, k.params, k.items, k.offsets))
    outs = tuple(torch.full((n,) + s, float("nan"))
                 for s in ((), (nx,), (nx, nx))[:3 if k.derivs else 1])
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - len(outs))
    args = (n, x.data_ptr(), ctypes.addressof(tab), k.horizon, k.width,
            consts.data_ptr())
    if one_thread:
        assert k.derivs
        err = lib.ag_terminal_node_host(k.nj, *args, len(k.items), *ptrs)
    else:
        err = lib.ag_terminal_host(k.nj, int(k.derivs), *args, consts.numel(),
                                   len(k.items), *ptrs)
    assert err == 0
    del keep
    return outs


def check(name, got, want, derivs):
    labels = smoke.STAGE_OUT if derivs else ("xnext", "l")
    smoke.check_outputs(name, got, want, labels)


@pytest.mark.parametrize("view", ["refs", "tick"])
@pytest.mark.parametrize("derivs", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("spec_name", SPECS)
def test_lanes_match_plain(host_lib, panda, spec_name, derivs, view):
    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    refs, x, u, dt, t_idx = smoke.randomized_inputs(spec, model, N, seed=N,
                                                    device=CPU)
    if view == "tick":
        refs = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_stage(model, params, spec, derivs, CPU)
    got = run_host(host_lib, k, x, u, dt, t_idx, refs)
    check(f"{'K1' if derivs else 'K2'} {spec_name} {view}", got,
          k.plain(x, u, dt, t_idx, refs), derivs)


def arm():
    return build_model_from_urdf(URDF_2DOF, armature=np.array([0.1, 0.1]),
                                 dtype=torch.float32, device=CPU)


def arm_items(w=1.0):
    """Every kind the 2-DoF arm carries, weights scaled by w."""
    return (
        CostItem(name="state_reg", kind="state", weight=0.1 * w, update=True),
        CostItem(name="ctrl", kind="control", weight=1e-2 * w, update=True),
        CostItem(name="grav", kind="control_grav", weight=1e-3 * w),
        CostItem(name="goal", kind="frame_placement", weight=10.0 * w,
                 update=True, frame="tip"),
        CostItem(name="vel", kind="frame_velocity", weight=0.5 * w,
                 update=True, frame="tip", reference_frame="local"))


def arm_refs(spec, model, rng):
    """The spec's refs drawn from rng, the rotation reference kept."""
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    refs = default_references(spec, model, device=CPU)
    for key, val in refs.items():
        if key != "ee_rot:tip":
            refs[key] = f(rng.uniform(0.1, 1.0, tuple(val.shape)))
    return refs


@pytest.mark.parametrize("derivs", [True, False], ids=["K1", "K2"])
def test_lanes_match_plain_2dof(host_lib, derivs):
    """The 2-DoF arm: 4 lanes per node."""
    model, params = arm()
    T = 8
    spec = ProblemSpec(running_costs=arm_items(), terminal_costs=(),
                       horizon=T, dt=0.01)
    rng = np.random.default_rng(2)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
    refs = arm_refs(spec, model, rng)
    x = f(rng.normal(size=(N, 4)) * 0.5)
    u = f(rng.normal(size=(N, 2)))
    t_idx = torch.as_tensor(rng.integers(0, T, size=N))
    dt = f(rng.uniform(0.005, 0.03, N))
    k = cuda_costs.make_cuda_stage(model, params, spec, derivs, CPU)
    assert k.plan.table(refs, CPU)[0].n == len(k.layout)
    got = run_host(host_lib, k, x, u, dt, t_idx, refs)
    check(f"{'K1' if derivs else 'K2'} 2-DoF", got,
          k.plain(x, u, dt, t_idx, refs), derivs)


@pytest.mark.parametrize("dt_kind", ["float", "0-d"])
@pytest.mark.parametrize("derivs", [True, False], ids=["K1", "K2"])
def test_lanes_scalar_dt(host_lib, panda, derivs, dt_kind):
    """One dt for every node, as a Python float or a 0-d tensor: the
    wrapper broadcasts it (`dt_per_node`) and the plain version agrees."""
    model, params = panda
    spec = smoke.SPECS["flagship"](100, model)
    refs, x, u, _, t_idx = smoke.randomized_inputs(spec, model, N, seed=5,
                                                   device=CPU)
    dt = 0.0125 if dt_kind == "float" else torch.tensor(0.0125)
    k = cuda_costs.make_cuda_stage(model, params, spec, derivs, CPU)
    got = run_host(host_lib, k, x, u, dt, t_idx, refs)
    check(f"{'K1' if derivs else 'K2'} {dt_kind} dt", got,
          k.plain(x, u, dt, t_idx, refs), derivs)


@pytest.mark.parametrize("view", ["refs", "tick"])
@pytest.mark.parametrize("derivs", [True, False], ids=["K3", "K4"])
@pytest.mark.parametrize("spec_name", SPECS)
def test_terminal_lanes_match_plain(host_lib, panda, spec_name, derivs, view):
    """K3/K4: the gather of the horizon's ref row through the source table,
    then K3's item tangents one a lane and each lane's owned entries, or
    K4's item values one a lane."""
    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    refs, x, _, _, _ = smoke.randomized_inputs(spec, model, 5, seed=4,
                                               device=CPU)
    if view == "tick":
        refs = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_terminal(model, params, spec, derivs, CPU)
    smoke.check_outputs(f"{'K3' if derivs else 'K4'} {spec_name} {view}",
                        run_terminal_host(host_lib, k, x, refs),
                        k.plain(x, refs), ("l", "lx", "lxx"))


@pytest.mark.parametrize("spec_name", SPECS)
def test_terminal_lanes_match_one_thread(host_lib, panda, spec_name):
    """K3's lane program against the one-thread body it replaced
    (`terminal_node`), on the same gathered row."""
    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    refs, x, _, _, _ = smoke.randomized_inputs(spec, model, 5, seed=4,
                                               device=CPU)
    k = cuda_costs.make_cuda_terminal(model, params, spec, True, CPU)
    smoke.check_outputs(f"K3 {spec_name} vs one-thread body",
                        run_terminal_host(host_lib, k, x, refs),
                        run_terminal_host(host_lib, k, x, refs,
                                          one_thread=True),
                        ("l", "lx", "lxx"))


@pytest.mark.parametrize("derivs", [True, False], ids=["K3", "K4"])
def test_terminal_lanes_2dof(host_lib, derivs):
    """The 2-DoF arm (K3: 4 lanes per node) with every kind in the
    terminal model: the control items see u = 0, control_grav still adds
    its gravity Jacobian's Gauss-Newton term to lxx, frame_velocity takes
    all 2 NJ tangents."""
    model, params = arm()
    spec = ProblemSpec(running_costs=arm_items(),
                       terminal_costs=arm_items(5.0), horizon=8, dt=0.01)
    rng = np.random.default_rng(3)
    refs = arm_refs(spec, model, rng)
    x = torch.as_tensor(rng.normal(size=(N, 4)) * 0.5, dtype=torch.float32)
    k = cuda_costs.make_cuda_terminal(model, params, spec, derivs, CPU)
    got = run_terminal_host(host_lib, k, x, refs)
    labels = ("l", "lx", "lxx")
    smoke.check_outputs(f"{'K3' if derivs else 'K4'} 2-DoF", got,
                        k.plain(x, refs), labels)
    if derivs:
        smoke.check_outputs("K3 2-DoF vs one-thread body", got,
                            run_terminal_host(host_lib, k, x, refs,
                                              one_thread=True), labels)


@pytest.fixture(scope="module")
def tiago():
    return load_tiago_pro(dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("view", ["refs", "tick"])
@pytest.mark.parametrize("derivs", [True, False], ids=["K1", "K2"])
@pytest.mark.parametrize("n", smoke.TIAGO_STAGE_SIZES)
def test_lanes_match_plain_tiago(host_lib, tiago, n, derivs, view):
    """The 8-joint Tiago-Pro arm: 16 lanes per node, every lane a tangent."""
    model, params = tiago
    spec = smoke.tiago_spec(smoke.TIAGO_T)
    refs, x, u, dt, t_idx = smoke.tiago_inputs(spec, model, n, n + derivs,
                                               CPU)
    if view == "tick":
        refs = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_stage(model, params, spec, derivs, CPU)
    got = run_host(host_lib, k, x, u, dt, t_idx, refs)
    check(f"{'K1' if derivs else 'K2'} tiago N={n} {view}", got,
          k.plain(x, u, dt, t_idx, refs), derivs)


@pytest.mark.parametrize("dt_kind", ["float", "0-d"])
@pytest.mark.parametrize("derivs", [True, False], ids=["K1", "K2"])
def test_lanes_scalar_dt_tiago(host_lib, tiago, derivs, dt_kind):
    """The Tiago-Pro arm with one dt for every node."""
    model, params = tiago
    spec = smoke.tiago_spec(smoke.TIAGO_T)
    refs, x, u, _, t_idx = smoke.tiago_inputs(spec, model, N, 6, CPU)
    dt = 0.02 if dt_kind == "float" else torch.tensor(0.02)
    k = cuda_costs.make_cuda_stage(model, params, spec, derivs, CPU)
    got = run_host(host_lib, k, x, u, dt, t_idx, refs)
    check(f"{'K1' if derivs else 'K2'} tiago {dt_kind} dt", got,
          k.plain(x, u, dt, t_idx, refs), derivs)


@pytest.mark.parametrize("view", ["refs", "tick"])
@pytest.mark.parametrize("derivs", [True, False], ids=["K3", "K4"])
def test_terminal_lanes_tiago(host_lib, tiago, derivs, view):
    """K3/K4 on the Tiago-Pro arm at phase 7's one terminal node (and five
    more), K3 also against its one-thread body."""
    model, params = tiago
    spec = smoke.tiago_spec(smoke.TIAGO_T)
    labels = ("l", "lx", "lxx")
    for n in (1, 5):
        refs, x, _, _, _ = smoke.tiago_inputs(spec, model, n, 4, CPU)
        if view == "tick":
            refs = smoke.tick_views(spec, model, refs)
        k = cuda_costs.make_cuda_terminal(model, params, spec, derivs, CPU)
        got = run_terminal_host(host_lib, k, x, refs)
        name = f"{'K3' if derivs else 'K4'} tiago N={n} {view}"
        smoke.check_outputs(name, got, k.plain(x, refs), labels)
        if derivs:
            smoke.check_outputs(f"{name} vs one-thread body", got,
                                run_terminal_host(host_lib, k, x, refs,
                                                  one_thread=True), labels)


# joint counts past the Panda's and the arm's: the full 17-DoF Tiago-Pro
# (branched, 32 lanes a node, lanes 0-1 two tangents each), a 4-joint
# Tiago-Pro chain (the torso and the left arm's first three joints; 8 lanes
# a node) and the 2-joint fork (a prismatic joint on the base, no serial
# chain; 4 lanes a node)
CHAIN4 = ["torso_lift_joint", "left_arm_1_joint", "left_arm_2_joint",
          "left_arm_3_joint"]


def _joint_count_case(robot, n, seed):
    """(model, params, spec, refs, x, u, dt, t_idx) of one robot."""
    from agimus_controller_tpu_torch.models.tiago_pro import TIAGO_PRO_Q_READY
    from tests.test_torch_step_lanes import URDF_FORK

    if robot == "fork":
        model, params = build_model_from_urdf(
            URDF_FORK, armature=np.array([0.1, 0.1]), dtype=torch.float32,
            device=CPU)
        spec = ProblemSpec(running_costs=arm_items(),
                           terminal_costs=arm_items(5.0), horizon=8, dt=0.01)
        rng = np.random.default_rng(seed)
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)
        refs = arm_refs(spec, model, rng)
        x = f(rng.normal(size=(n, 4)) * 0.5)
        u = f(rng.normal(size=(n, 2)))
        t_idx = torch.as_tensor(rng.integers(0, 8, size=n))
        return (model, params, spec, refs, x, u,
                f(rng.uniform(0.005, 0.03, n)), t_idx)
    if robot == "tiago17":
        model, params = load_tiago_pro(moving_joint_names="all",
                                       dtype=torch.float32, device=CPU)
        spec, q_ready = smoke.tiago_full_spec(smoke.TIAGO_T), \
            smoke.tiago_full_ready()
    else:
        model, params = load_tiago_pro(moving_joint_names=CHAIN4,
                                       dtype=torch.float32, device=CPU)
        spec, q_ready = smoke.tiago_spec(smoke.TIAGO_T), TIAGO_PRO_Q_READY[:4]
    return (model, params, spec) + smoke.tiago_inputs(spec, model, n, seed,
                                                      CPU, q_ready)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
@pytest.mark.parametrize("robot", ["tiago17", "chain4", "fork"])
def test_lanes_joint_counts(host_lib, robot, kernel):
    """K1/K2 at phase 9's node count (20), K3/K4 at one node and five,
    against the plain versions; K3 also against its one-thread body."""
    derivs = kernel in ("K1", "K3")
    if kernel in ("K1", "K2"):
        model, params, spec, refs, x, u, dt, t_idx = _joint_count_case(
            robot, 20, 20 + derivs)
        assert model.nj == {"tiago17": 17, "chain4": 4, "fork": 2}[robot]
        k = cuda_costs.make_cuda_stage(model, params, spec, derivs, CPU)
        check(f"{kernel} {robot}", run_host(host_lib, k, x, u, dt, t_idx,
                                            refs),
              k.plain(x, u, dt, t_idx, refs), derivs)
        return
    labels = ("l", "lx", "lxx")
    for n in (1, 5):
        model, params, spec, refs, x, *_ = _joint_count_case(robot, n, 4)
        k = cuda_costs.make_cuda_terminal(model, params, spec, derivs, CPU)
        got = run_terminal_host(host_lib, k, x, refs)
        smoke.check_outputs(f"{kernel} {robot} N={n}", got,
                            k.plain(x, refs), labels)
        if derivs:
            smoke.check_outputs(f"{kernel} {robot} N={n} vs one-thread body",
                                got, run_terminal_host(host_lib, k, x, refs,
                                                       one_thread=True),
                                labels)
