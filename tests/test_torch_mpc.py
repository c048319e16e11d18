"""The port's `MPC` and warm starts vs the JAX package, f64.

- `MPC` over the unicycle OCP of `test_mpc.py` (the reference's mock
  backend pattern): the JAX `MPC` runs JAX's `UnicycleOCP`, the port's
  `MPC` the same OCP written in PyTorch over the port's `solve_fddp`;
  30 receding-horizon iterations from the same stream, with the predicted
  states, controls and gains equal at 1e-8 each iteration, the horizon
  heads and the closed-loop consistency of `test_mpc.py`.
- `WarmStartReference` (batched RNEA along the reference) and
  `WarmStartShiftPreviousSolution` (uniform and non-uniform horizons) on the
  Panda against the JAX warm starts at 1e-10.
"""

import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.mpc import buffer as jbuffer
from agimus_controller_tpu.mpc import warm_start as jws
from agimus_controller_tpu.mpc.data import OCPResults as JaxResults
from agimus_controller_tpu.mpc.mpc import MPC as JaxMPC
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu_torch.mpc.buffer import (
    DTFactorsNSeq,
    TrajectoryBuffer,
    TrajectoryPoint,
)
from agimus_controller_tpu_torch.mpc.data import OCPDebugData, OCPResults
from agimus_controller_tpu_torch.mpc.mpc import MPC
from agimus_controller_tpu_torch.mpc.ocp_base import OCPBase
from agimus_controller_tpu_torch.mpc.warm_start import (
    WarmStartBase,
    WarmStartReference,
    WarmStartShiftPreviousSolution,
)
from agimus_controller_tpu_torch.ocp.costs import StageDerivs, TerminalDerivs
from agimus_controller_tpu_torch.solver.fddp import SolverSettings, solve_fddp
from tests.test_mpc import DT, UnicycleOCP, UnicycleWarmStart, unicycle_point

# -- the unicycle backend in PyTorch (`test_mpc.py:43-150`) --------------------


class UnicycleCosts:
    """The unicycle tracking OCP of `test_mpc.make_unicycle_cf` as the
    batched functions `solve_fddp` reads, with analytic derivatives."""

    def __init__(self, T):
        self.T = T

    @staticmethod
    def step(x, u):
        c, s = torch.cos(x[..., 2]), torch.sin(x[..., 2])
        return x + DT * torch.stack([u[..., 0] * c, u[..., 0] * s, u[..., 1]], -1)

    def step_b(self, x, u, t, refs):
        return self.step(x, u)

    def value(self, x, u, t, refs):
        e = x - refs["xref"][t]
        return DT * (5.0 * (e * e).sum(-1) + 0.1 * (u * u).sum(-1))

    def terminal_cost(self, x, refs):
        e = x - refs["xref"][self.T]
        return 5.0 * (e * e).sum(-1)

    term_value = terminal_cost

    def stage_derivs_b(self, x, u, t, refs):
        N = x.shape[0]
        e = x - refs["xref"][t]
        eye = lambda n: torch.eye(n, dtype=x.dtype).expand(N, n, n)  # noqa: E731
        c, s = torch.cos(x[:, 2]), torch.sin(x[:, 2])
        z = torch.zeros_like(c)
        Fx = eye(3) + DT * torch.stack([
            torch.stack([z, z, -u[:, 0] * s], -1),
            torch.stack([z, z, u[:, 0] * c], -1),
            torch.stack([z, z, z], -1)], 1)
        Fu = DT * torch.stack([torch.stack([c, z], -1), torch.stack([s, z], -1),
                               torch.stack([z, z + 1.0], -1)], 1)
        return StageDerivs(
            self.value(x, u, t, refs), DT * 10.0 * e, DT * 0.2 * u,
            DT * 10.0 * eye(3), x.new_zeros((N, 3, 2)), DT * 0.2 * eye(2),
            self.step(x, u), Fx, Fu)

    def terminal_derivs(self, x, refs):
        e = x - refs["xref"][self.T]
        return TerminalDerivs(self.terminal_cost(x, refs), 10.0 * e,
                              10.0 * torch.eye(3, dtype=x.dtype))


class TorchUnicycleOCP(OCPBase):
    """`test_mpc.UnicycleOCP` over the port's `solve_fddp`."""

    def __init__(self, T):
        self._T = T
        self._cf = UnicycleCosts(T)
        self._refs = {"xref": torch.zeros((T + 1, 3), dtype=torch.float64)}
        self._results = None
        self._debug = OCPDebugData()
        self.horizon_seen = []

    @property
    def n_controls(self):
        return self._T

    @property
    def dt(self):
        return DT

    def set_reference_weighted_trajectory(self, pts):
        self.horizon_seen.append([wp.point.id for wp in pts])
        xref = np.stack([np.concatenate([wp.point.robot_configuration,
                                         wp.point.robot_velocity])
                         for wp in pts])
        self._refs = {"xref": torch.as_tensor(xref)}

    def solve(self, x0, x_ws, u_ws, use_iteration_limits_and_timeout=True):
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64)  # noqa: E731
        sol = solve_fddp(self._cf, t(x0), self._refs, t(np.stack(x_ws)),
                         t(np.stack(u_ws)), SolverSettings(max_iters=20))
        self._results = OCPResults(
            states=sol.xs.numpy(), ricatti_gains=sol.K.numpy(),
            feed_forward_terms=sol.us.numpy())
        self._debug.kkt_norm = float(sol.kkt)
        self._debug.problem_solved = bool(sol.converged)
        return self._results

    def integrate(self, state, control):
        return UnicycleCosts.step(torch.as_tensor(state),
                                  torch.as_tensor(control)).numpy()

    @property
    def ocp_results(self):
        return self._results

    @property
    def debug_data(self):
        return self._debug


class TorchUnicycleWarmStart(WarmStartBase):
    def setup(self, *args):
        pass

    def generate(self, initial_state, reference_trajectory):
        x0 = initial_state.robot_state
        x_init = [np.asarray(x0)] + [p.robot_state
                                     for p in reference_trajectory[1:]]
        u_init = [np.zeros(2) for _ in range(len(reference_trajectory) - 1)]
        return np.asarray(x0), x_init, u_init


N_ITERS = 30


def _drive(mpc, ocp, point_cls, buffer_point):
    """`test_mpc.test_mpc_unicycle_receding_horizon`'s loop; returns the
    per-iteration (states, us, K, state after the applied control)."""
    T = ocp.n_controls
    for i in range(T + 1):
        mpc.append_trajectory_point(buffer_point(i))
    x = np.asarray([0.0, 0.0, np.pi / 2])
    state = point_cls(id=0, time_ns=0, robot_configuration=x[:2],
                      robot_velocity=x[2:])
    out = []
    for it in range(N_ITERS):
        res = mpc.run(state, int(it * DT * 1e9))
        assert res is not None
        assert ocp.horizon_seen[-1][0] == it
        xn = ocp.integrate(state.robot_state, res.feed_forward_terms[0])
        np.testing.assert_allclose(res.states[1], xn, atol=1e-10)
        out.append((res.states, res.feed_forward_terms, res.ricatti_gains, xn))
        state = point_cls(id=it + 1, time_ns=int((it + 1) * DT * 1e9),
                          robot_configuration=xn[:2], robot_velocity=xn[2:])
        mpc.append_trajectory_point(buffer_point(T + 1 + it))
    return out


def _port_point(i):
    """`test_mpc.unicycle_point` with the port's point types."""
    from agimus_controller_tpu_torch.mpc.buffer import (
        TrajectoryPointWeights,
        WeightedTrajectoryPoint,
    )

    wp = unicycle_point(i, int(i * DT * 1e9))
    return WeightedTrajectoryPoint(
        point=TrajectoryPoint(**vars(wp.point)),
        weights=TrajectoryPointWeights(**vars(wp.weights)))


def test_mpc_unicycle_matches_jax():
    T = 10
    jocp, pocp = UnicycleOCP(T), TorchUnicycleOCP(T)
    jmpc, pmpc = JaxMPC(), MPC()
    jmpc.setup(jocp, UnicycleWarmStart(),
               jbuffer.TrajectoryBuffer(jbuffer.DTFactorsNSeq([1], [T])))
    pmpc.setup(pocp, TorchUnicycleWarmStart(),
               TrajectoryBuffer(DTFactorsNSeq([1], [T])))
    want = _drive(jmpc, jocp, jbuffer.TrajectoryPoint,
                  lambda i: unicycle_point(i, int(i * DT * 1e9)))
    got = _drive(pmpc, pocp, TrajectoryPoint, _port_point)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-8)
    assert pocp.horizon_seen == jocp.horizon_seen
    dbg = pmpc.mpc_debug_data
    assert dbg.reference_id == jmpc.mpc_debug_data.reference_id == N_ITERS - 1
    assert dbg.duration_iteration_ns > 0 and dbg.duration_ocp_solve_ns > 0
    assert dbg.duration_horizon_update_ns > 0
    assert dbg.duration_generate_warm_start_ns > 0


def test_mpc_underfilled_buffer_returns_none():
    T = 10
    mpc = MPC()
    mpc.setup(TorchUnicycleOCP(T), TorchUnicycleWarmStart(),
              TrajectoryBuffer(DTFactorsNSeq(factors=[1], n_steps=[T])))
    state = TrajectoryPoint(id=0, time_ns=0, robot_configuration=np.zeros(2),
                            robot_velocity=np.zeros(1))
    assert mpc.run(state, 0) is None
    with pytest.raises(RuntimeError, match="setup"):
        MPC().run(state, 0)


# -- the warm starts on the Panda ---------------------------------------------

@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(dtype=np.float64)
    pm, pp = load_panda(dtype=torch.float64, device="cpu")
    return jm, jp, pm, pp


def test_warm_start_reference_matches_jax(panda):
    jm, jp, pm, pp = panda
    jw, pw = jws.WarmStartReference(), WarmStartReference()
    jw.setup(jm, jp)
    pw.setup(pm, pp, device="cpu")
    rng = np.random.default_rng(0)
    pts = [TrajectoryPoint(
        id=i, time_ns=i,
        robot_configuration=PANDA_Q_READY + 0.05 * rng.normal(size=7),
        robot_velocity=0.1 * rng.normal(size=7),
        robot_acceleration=(None if i == 3 else 0.1 * rng.normal(size=7)))
        for i in range(6)]
    x0pt = TrajectoryPoint(robot_configuration=PANDA_Q_READY + 0.01,
                           robot_velocity=np.full(7, 0.02))
    (jx0, jxs, jus), (px0, pxs, pus) = (w.generate(x0pt, pts) for w in (jw, pw))
    assert len(pxs) == 6 and len(pus) == 5
    np.testing.assert_array_equal(px0, jx0)
    np.testing.assert_array_equal(np.stack(pxs), np.stack(jxs))
    np.testing.assert_allclose(np.stack(pus), np.stack(jus), rtol=0, atol=1e-10)


def _previous(T, seed):
    rng = np.random.default_rng(seed)
    xs = np.concatenate([PANDA_Q_READY + 0.1 * rng.normal(size=(T + 1, 7)),
                         0.1 * rng.normal(size=(T + 1, 7))], axis=1)
    us = 0.5 * rng.normal(size=(T, 7))
    return xs, us


@pytest.mark.parametrize("timesteps", [
    (0.01, 0.01, 0.01, 0.01),
    (0.01, 0.01, 0.02, 0.02),
    (0.01, 0.02, 0.04, 0.04, 0.04),
], ids=["uniform", "factors_1_2", "factors_1_2_4"])
def test_warm_start_shift_matches_jax(panda, timesteps):
    """Uniform nodes copy their successor; nodes inside a coarser segment
    advance one base dt with their control (Euler step on the device)."""
    jm, jp, pm, pp = panda
    T = len(timesteps)
    xs, us = _previous(T, seed=T)
    jw, pw = jws.WarmStartShiftPreviousSolution(), WarmStartShiftPreviousSolution()
    jw.setup(jm, jp, np.asarray(timesteps))
    pw.setup(pm, pp, np.asarray(timesteps), device="cpu")
    jw.update_previous_solution(JaxResults(
        states=xs.copy(), ricatti_gains=np.zeros((T, 7, 14)),
        feed_forward_terms=us.copy()))
    pw.update_previous_solution(OCPResults(
        states=xs.copy(), ricatti_gains=np.zeros((T, 7, 14)),
        feed_forward_terms=us.copy()))
    x0pt = TrajectoryPoint(robot_configuration=np.zeros(7),
                           robot_velocity=np.zeros(7))
    (_, jx, ju), (_, px, pu) = (w.generate(x0pt, [None] * (T + 1))
                                for w in (jw, pw))
    np.testing.assert_allclose(np.stack(px), np.stack(jx), rtol=0, atol=1e-10)
    np.testing.assert_array_equal(np.stack(pu), np.stack(ju))
    # the fine nodes shift exactly, the last control is held
    np.testing.assert_array_equal(px[0], xs[1])
    np.testing.assert_array_equal(pu[-1], us[-1])
    if timesteps[-1] != timesteps[0]:
        assert not np.allclose(px[-2], xs[-1])  # re-integrated, not copied
