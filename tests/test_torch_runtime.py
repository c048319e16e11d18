"""The port's controller runtime vs the JAX package, f64.

A 12-tick closed loop through `ControllerRuntime` on the 2-DoF planar arm
(T=8, dt = 2^-6, see `test_torch_ocp_base.py`): the ring-fed "sqp"
`OCPTorch` with debug streams and constant-delay compensation, the init gate,
the unlimited first solve from the reference warm start, the budget
calibration, the shift warm start, the measured state closed through
`ocp.integrate`; against the JAX runtime on the same stream, states,
controls and gains at 1e-8, iteration counts equal. Also the debug streams'
keys, shapes and values, the ring against host packing (1e-10), the desync
assertion, and the port's `FusedTickRunner` against the port's runtime path
(1e-10, `test_ring_control_loop.py`'s JAX test on the port).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.mpc import warm_start as jws
from agimus_controller_tpu.mpc.mpc import MPC as JaxMPC
from agimus_controller_tpu.mpc.ocp_base import OCPJax, OCPParams as JaxParams
from agimus_controller_tpu.mpc.ring import (
    PackedTrajectoryBuffer as JaxBuffer,
    RowLayout as JaxRowLayout,
)
from agimus_controller_tpu.runtime import controller as jrt
from agimus_controller_tpu_torch.mpc.buffer import DTFactorsNSeq
from agimus_controller_tpu_torch.mpc.mpc import MPC
from agimus_controller_tpu_torch.mpc.ocp_base import OCPParams, OCPTorch
from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
from agimus_controller_tpu_torch.mpc.warm_start import (
    WarmStartReference,
    WarmStartShiftPreviousSolution,
)
from agimus_controller_tpu_torch.runtime.controller import (
    ControllerRuntime,
    RuntimeParams,
    Sensor,
)
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from tests.test_ring_control_loop import Q0, T
from tests.test_torch_ocp_base import (
    ATOL,
    DT_EXACT,
    _close,
    _params,
    _point,
    _same_results,
    _specs,
    arm,  # noqa: F401  (fixture)
)

SEQ = DTFactorsNSeq(factors=[1], n_steps=[T])


N_TICKS = 12


def _runtime(pkg, arm, delay):
    """(runtime, buffer, ocp, mpc) of one package: ring-fed sqp OCP with
    debug streams, shift warm start, reference warm start for the first
    solve (`test_ring_control_loop.py`'s loop)."""
    js, ps = _specs("goal", DT_EXACT)
    if pkg == "jax":
        buf = JaxBuffer(SEQ, JaxRowLayout(js, arm["jm"]), dtype=jnp.float64)
        ocp = OCPJax(arm["jm"], arm["jp"], js, _params(
            JaxParams, "sqp", DT_EXACT, max_solve_time=10.0,
            use_debug_data=True), dtype=jnp.float64, ring=buf.ring)
        ws, ws_ref = jws.WarmStartShiftPreviousSolution(), jws.WarmStartReference()
        ws.setup(arm["jm"], arm["jp"], js.timesteps())
        ws_ref.setup(arm["jm"], arm["jp"])
        mpc = JaxMPC()
        mpc.setup(ocp, ws, buf)
        rt = jrt.ControllerRuntime(mpc, buf, ws_ref,
                                   jrt.RuntimeParams(constant_delay=delay))
        return rt, buf, ocp, mpc
    buf = PackedTrajectoryBuffer(SEQ, RowLayout(ps, arm["pm"]),
                                 dtype=torch.float64, device="cpu")
    ocp = OCPTorch(arm["pm"], arm["pp"], ps, _params(
        OCPParams, "sqp", DT_EXACT, max_solve_time=10.0, use_debug_data=True),
        dtype=torch.float64, ring=buf.ring, device="cpu")
    ws, ws_ref = WarmStartShiftPreviousSolution(), WarmStartReference()
    ws.setup(arm["pm"], arm["pp"], ps.timesteps(), device="cpu")
    ws_ref.setup(arm["pm"], arm["pp"], device="cpu")
    mpc = MPC()
    mpc.setup(ocp, ws, buf)
    rt = ControllerRuntime(mpc, buf, ws_ref, RuntimeParams(constant_delay=delay))
    return rt, buf, ocp, mpc


def _drive(pkg, arm, delay):
    """Run the loop: init gate, first solve, N_TICKS ticks with the measured
    state closed through `ocp.integrate` of the published control. Returns
    (runtime parts, per-tick (u, K, x, kkt, iters))."""
    rt, buf, ocp, mpc = parts = _runtime(pkg, arm, delay)
    Sens = jrt.Sensor if pkg == "jax" else Sensor
    x = np.concatenate([Q0 + [0.03, -0.02], np.zeros(2)])
    rt.set_sensor(Sens(time_ns=0, position=x[:2].copy(), velocity=x[2:].copy()))
    assert rt.step() is None  # empty buffer: the init gate holds
    n_fill = 3 * T
    for i in range(n_fill):
        rt.append_reference(_point(i, arm, DT_EXACT))
    trace = []
    for k in range(N_TICKS + 1):
        now = int(k * DT_EXACT * 1e9)
        rt.set_sensor(Sens(time_ns=now, position=x[:2].copy(),
                           velocity=x[2:].copy()))
        ctrl = rt.step(now_ns=now)
        if k == 0:
            assert rt.initialized and ocp.budget_iters == 10
        dbg = mpc.mpc_debug_data.ocp
        trace.append((None if ctrl is None else ctrl.feedforward.copy(),
                      None if ctrl is None else ctrl.feedback_gain.copy(),
                      x.copy(), dbg.kkt_norm, dbg.nb_iter))
        if ctrl is not None:
            x = ocp.integrate(x, ctrl.feedforward)
        rt.append_reference(_point(n_fill + k, arm, DT_EXACT))
    return parts, trace


@pytest.fixture(scope="module")
def loops(arm):
    return {pkg: _drive(pkg, arm, delay=True) for pkg in ("jax", "port")}


def test_closed_loop_runtime_matches_jax(loops):
    (_, _, ocp, mpc), trace_p = loops["port"]
    _, trace_j = loops["jax"]
    # constant delay: the first tick publishes nothing, each later tick the
    # control solved for it on the tick before
    assert trace_p[0][0] is None and trace_j[0][0] is None
    for (u_p, K_p, x_p, kkt_p, it_p), (u_j, K_j, x_j, kkt_j, it_j) in zip(
            trace_p[1:], trace_j[1:]):
        _close(x_p, x_j)
        _close(u_p, u_j)
        _close(K_p, K_j)
        assert it_p == it_j and abs(kkt_p - kkt_j) < ATOL
    assert all(np.all(np.isfinite(t[0])) for t in trace_p[1:])
    assert mpc.mpc_debug_data.ocp.problem_solved
    dbg = mpc.mpc_debug_data
    assert dbg.duration_iteration_ns >= dbg.duration_ocp_solve_ns > 0
    assert dbg.reference_id is not None
    # the facade reads back once per solve, once per debug-stream fill and
    # once per integrate: the first solve and the first tick (2 + 2), then
    # per tick the delay-compensation step, the solve with its streams and
    # the loop's own integrate; the calibration solves read nothing back
    assert ocp.host_syncs == 4 + 4 * N_TICKS
    assert ocp.solver_host_syncs > 0


def test_debug_streams_match_jax(loops):
    """The per-tick streams: every update=True cost's reference ("ctrl" is
    update=False), the publish_residual cost's residual at every running
    node, equal to JAX's."""
    dbg_p = loops["port"][0][3].mpc_debug_data.ocp
    dbg_j = loops["jax"][0][3].mpc_debug_data.ocp
    assert set(dbg_p.references) == set(dbg_j.references) == {"state_reg", "goal"}
    assert dbg_p.references["goal"].shape == (T + 1, 3)
    assert dbg_p.references["state_reg"].shape == (T + 1, 4)
    assert set(dbg_p.residuals) == set(dbg_j.residuals) == {"goal"}
    assert dbg_p.residuals["goal"].shape == (T, 6)
    for k in dbg_p.references:
        _close(dbg_p.references[k], dbg_j.references[k])
    _close(dbg_p.residuals["goal"], dbg_j.residuals["goal"])


def test_ring_matches_host_and_rejects_desync(arm, loops):
    """The ring-gathered refs give the same solution as host packing, and a
    horizon that disagrees with the ring head is rejected."""
    rt, buf, ocp, _ = loops["port"][0]
    horizon = buf.horizon
    x0 = np.concatenate([Q0, np.zeros(2)])
    xs = [x0.copy() for _ in range(T + 1)]
    us = [arm["tau_g"].copy() for _ in range(T)]
    res_ring = ocp.solve(x0, xs, us)
    host = OCPTorch(arm["pm"], arm["pp"], ocp.spec, _params(
        OCPParams, "sqp", DT_EXACT), dtype=torch.float64, device="cpu")
    host.set_reference_weighted_trajectory(horizon)
    res_host = host.solve(x0, xs, us)
    _same_results(res_ring, res_host, 1e-10)
    bogus = [_point(5000 + i, arm, DT_EXACT) for i in range(T + 1)]
    with pytest.raises(AssertionError, match="desync"):
        ocp.set_reference_weighted_trajectory(bogus)


def test_fused_tick_matches_runtime_path(arm):
    """The port's fused tick (device-resident shift + ring gather + solve)
    gives the control of the step-by-step `ControllerRuntime` path from the
    same previous solution and stream (`test_ring_control_loop.py`'s JAX
    test, on the port)."""
    rt, buf, ocp, mpc = _runtime("port", arm, delay=False)
    rt.set_sensor(Sensor(time_ns=0, position=Q0.copy(), velocity=np.zeros(2)))
    for i in range(3 * T):
        rt.append_reference(_point(i, arm, DT_EXACT))
    for k in range(3):
        rt.set_sensor(Sensor(time_ns=int(k * DT_EXACT * 1e9),
                             position=Q0.copy(), velocity=np.zeros(2)))
        assert rt.step() is not None
        rt.append_reference(_point(3 * T + k, arm, DT_EXACT))
    prev = mpc._warm_start._previous_solution
    fused = FusedTickRunner(
        arm["pm"], arm["pp"], ocp.spec, buf.ring, ocp.refs,
        CSQPSettings(max_iters=10, max_qp_iters=200,
                     termination_tolerance=1e-6, reg_init=1e-7),
        dtype=torch.float64, device="cpu")
    x0 = np.concatenate([Q0, np.zeros(2)])
    fused._xs = torch.as_tensor(prev.states)
    fused._us = torch.as_tensor(prev.feed_forward_terms)
    out = fused._run(x0, fused._xs, fused._us, limit=10)
    K0_f, u0_f, kkt_f, _, conv_f = fused.fetch(out)
    rt.set_sensor(Sensor(time_ns=10**9, position=Q0.copy(),
                         velocity=np.zeros(2)))
    ctrl = rt.step()
    _close(u0_f, ctrl.feedforward, 1e-10)
    _close(K0_f, ctrl.feedback_gain, 1e-10)
    assert conv_f == rt.last_problem_solved
    assert abs(kkt_f - mpc.mpc_debug_data.ocp.kkt_norm) < 1e-9
