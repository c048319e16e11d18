"""The reference against the program's plain CPU path, in float64, at small
sizes: the Panda chain and the full Tiago-Pro's branched tree with its
prismatic torso. Step, step Jacobians, gravity, FK and the goals, the OCP's
cost values and Gauss-Newton derivatives, and a Riccati pass."""

import numpy as np
import pytest
import torch

import harness
import reference
from _small_cells import load
from reference.model import round_tf32
from reference.ocp import riccati, step_derivs

F64 = torch.float64
CELLS = {"panda": "panda-t20-batch4096", "tiago": "tiago-full-t20-batch4096"}
TOL = 1e-10


@pytest.fixture(scope="module", params=sorted(CELLS))
def pair(request):
    """(reference robot, costs, goals; the program's model, params,
    cost functions and float64 refs on the same inputs; the config)."""
    from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
    from agimus_controller_tpu_torch.ocp.costs import build_cost_functions

    cell = load(CELLS[request.param])
    cfg = cell.config
    robot, costs, goals = reference.build(cfg, cell.urdf, cfg["goal_offsets"])
    model, params = build_model_from_urdf(
        cell.urdf, armature=np.full(robot.nj, cfg["armature"]), dtype=F64,
        device="cpu")
    problem = harness.build_problem(cell, "cpu", horizon=5)
    refs = {k: v.double() for k, v in problem.refs.items()}
    cf = build_cost_functions(model, params, problem.spec, F64)
    return dict(robot=robot, costs=costs, goals=goals, model=model,
                params=params, cf=cf, refs=refs, cfg=cfg)


def nodes(p, n=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    nj = p["robot"].nj
    q = (torch.as_tensor(p["cfg"]["q_ready"], dtype=F64)
         + 0.3 * torch.randn(n, nj, generator=g, dtype=F64))
    v = torch.randn(n, nj, generator=g, dtype=F64)
    u = 5.0 * torch.randn(n, nj, generator=g, dtype=F64)
    return torch.cat([q, v], 1), u


def close(a, b, tol=TOL):
    scale = max(1.0, float(b.abs().max()))
    assert float((a - b).abs().max()) <= tol * scale


def test_joint_order(pair):
    assert pair["robot"].tree.joint_names == list(pair["model"].joint_names)
    assert pair["robot"].tree.joint_names == pair["cfg"]["joints"]


def test_step_and_jacobians(pair):
    from agimus_controller_tpu_torch.ops import integrator

    x, u = nodes(pair)
    dt = torch.full((x.shape[0],), 0.01, dtype=F64)
    xn, Fx, Fu = step_derivs(pair["robot"], x, u, dt)
    for i in range(x.shape[0]):
        want = integrator.euler_step_with_derivatives(
            pair["model"], pair["params"], x[i], u[i], 0.01)
        close(xn[i], want[0])
        close(Fx[i], want[1])
        close(Fu[i], want[2])


def test_gravity_and_mass_matrix(pair):
    from agimus_controller_tpu_torch.ops import dynamics

    x, _ = nodes(pair)
    q = x[:, :pair["robot"].nj]
    for i in range(q.shape[0]):
        close(pair["robot"].gravity_torque(q[i]),
              dynamics.generalized_gravity(pair["model"], pair["params"], q[i]))
        close(pair["robot"].mass_matrix(q[i]),
              dynamics.crba(pair["model"], pair["params"], q[i]))


def test_fk_and_goals(pair):
    from agimus_controller_tpu_torch.ops.kinematics import frame_placement

    model, params, robot = pair["model"], pair["params"], pair["robot"]
    x, _ = nodes(pair)
    q_ready = torch.as_tensor(pair["cfg"]["q_ready"], dtype=F64)
    for frame, off in pair["cfg"]["goal_offsets"].items():
        fid = model.frame_id(frame)
        for q in x[:, :robot.nj]:
            R, p = robot.frame_placement(q, frame)
            Rw, pw = frame_placement(model, params, q, fid)
            close(R, Rw)
            close(p, pw)
        R0, p0 = frame_placement(model, params, q_ready, fid)
        Rg, pg = pair["goals"][frame]
        assert np.abs(Rg - R0.numpy()).max() < 1e-7  # float32 inputs
        assert np.abs(pg - (p0.numpy() + off)).max() < 1e-7


def test_cost_values_and_derivatives(pair):
    cf, costs, refs = pair["cf"], pair["costs"], pair["refs"]
    x, u = nodes(pair, seed=1)
    dt = torch.full((x.shape[0],), pair["cfg"]["dt"], dtype=F64)
    run = costs.running_derivs(x, u, dt)
    term = costs.terminal_derivs(x)
    vals = costs.running_value(x, u, dt)
    tvals = costs.terminal_value(x)
    for i in range(x.shape[0]):
        for got, want in zip(run, cf.cost_derivs(x[i], u[i], 0, refs)):
            close(got[i], want)
        for got, want in zip(term, cf.terminal_derivs(x[i], refs)):
            close(got[i], want)
        close(vals[i], cf.stage_cost(x[i], u[i], 0, refs))
        close(tvals[i], cf.terminal_cost(x[i], refs))


def test_riccati(pair):
    from agimus_controller_tpu_torch.solver.fddp_batch import backward_dense

    g = torch.Generator().manual_seed(2)
    nx, nu, T, B = 2 * pair["robot"].nj, pair["robot"].nj, 4, 3
    r = lambda *s: torch.randn(*s, generator=g, dtype=F64)
    Fx = torch.eye(nx, dtype=F64) + 0.1 * r(T, B, nx, nx)
    Fu = r(T, B, nx, nu)
    A, C = r(T, B, nx, nx), r(B, nx, nx)
    lxx, tlxx = A @ A.transpose(-1, -2), C @ C.transpose(-1, -2)
    luu = torch.eye(nu, dtype=F64).expand(T, B, nu, nu)
    lx, lu, lxu, fs, tlx = (r(T, B, nx), r(T, B, nu), 0.1 * r(T, B, nx, nu),
                            0.1 * r(T + 1, B, nx), r(B, nx))
    reg = torch.full((B,), 1e-9, dtype=F64)
    ks, Ks, Qus, *_ = backward_dense(Fx, Fu, lx, lu, lxx, lxu, luu, fs, tlx,
                                     tlxx, reg)
    tr = lambda a: a.transpose(0, 1)
    K, k, Qu = riccati(pair["robot"], tr(Fx), tr(Fu), tr(lx), tr(lu),
                       tr(lxx), tr(lxu), tr(luu), tr(fs), tlx, tlxx, reg)
    close(K, tr(Ks))
    close(k, tr(ks))
    close(Qu, tr(Qus))


def test_tf32_rounding():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(3))
    r = round_tf32(x)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0 ** -11


def test_fddp_solve(pair):
    """The reference's own solve takes the program's iterations to the
    program's solution, in float64 from the same start and warm start."""
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
    from reference.fddp import solve

    cell = load(CELLS["panda" if pair["robot"].nj == 7 else "tiago"])
    settings = cell.mix["solver"]
    spec = harness.build_problem(cell, "cpu", horizon=5).spec
    solver = make_batch_fddp(pair["model"], pair["params"], spec,
                             SolverSettings(**settings), device="cpu")
    g = torch.Generator().manual_seed(4)
    nj, B, T = pair["robot"].nj, 3, spec.horizon
    ready = torch.as_tensor(pair["cfg"]["q_ready"], dtype=F64)
    x_ready = torch.cat([ready, torch.zeros(nj, dtype=F64)])
    x0 = x_ready + torch.cat([0.02 * torch.randn(B, nj, generator=g,
                                                 dtype=F64),
                              torch.zeros(B, nj, dtype=F64)], 1)
    xs = x_ready.expand(B, T + 1, -1).contiguous()
    us = torch.zeros(B, T, nj, dtype=F64)
    got = solver(x0, pair["refs"], xs, us)
    dts = torch.full((T,), pair["cfg"]["dt"], dtype=F64)
    want = solve(pair["robot"], pair["costs"], x0, xs, us, dts, settings)
    assert got.iters.tolist() == want["iters"].tolist()
    assert got.converged.tolist() == want["converged"].tolist()
    # the problem's Quu is ill-conditioned (control weight 1e-3 dt), so
    # the round-off of two float64 solves parts them by ~1e-8 relative
    close(got.xs, want["xs"], 1e-7)
    close(got.us, want["us"], 1e-7)
    close(got.K, want["K"], 1e-7)
    assert float(((got.cost - want["cost"]) / want["cost"]).abs().max()) < 1e-7
