"""Shared cases of the constrained batch-SQP comparisons (port vs JAX).

The 2-DoF planar arm of `test_ring_control_loop.py`, here with a capsule on
`l2` and a world-fixed sphere on the base, T=8, f64, dt = 2^-6 (exact in f32:
see `test_torch_tick.py`). Three constrained specs:

- `elbow_band`: the elbow band of `test_solver_smoke.py` (a frame-translation
  box on `l2`, nc=3) under the flagship-shaped costs, the tip goal pulling
  beyond what the band allows;
- `control_box`: the same costs with a `control_limit` box (nc=2) the
  solution rides;
- `yaml`: the shipped collision-avoidance YAML (quad_exp collision cost,
  alpha 1e-4, and the hard 1 cm distance constraint, nc=1), bound to `tip`.

Each case builds the JAX batch solver and the port's from the same inputs;
the comparisons live in `test_torch_csqp*.py`.
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from agimus_controller_tpu.models.urdf import build_model_from_urdf as jax_build
from agimus_controller_tpu.mpc.ring import (
    PackedTrajectoryBuffer as JaxBuffer,
    RowLayout as JaxRowLayout,
)
from agimus_controller_tpu.mpc.tick import FusedTickRunner as JaxRunner
from agimus_controller_tpu.ocp import spec as jspec
from agimus_controller_tpu.ocp.costs import build_cost_functions
from agimus_controller_tpu.ocp.yaml_compiler import load_ocp_spec as jax_load_ocp_spec
from agimus_controller_tpu.ops import dynamics, kinematics
from agimus_controller_tpu.solver.csqp import CSQPSettings as JaxSettings
from agimus_controller_tpu.solver.sqp_batch import make_batch_sqp as jax_make_batch_sqp
from agimus_controller_tpu_torch.models.model import params_from_numpy
from agimus_controller_tpu_torch.mpc.buffer import (
    DTFactorsNSeq,
    TrajectoryPoint,
    TrajectoryPointWeights,
    WeightedTrajectoryPoint,
)
from agimus_controller_tpu_torch.mpc.ring import PackedTrajectoryBuffer, RowLayout
from agimus_controller_tpu_torch.mpc.tick import FusedTickRunner
from agimus_controller_tpu_torch.ocp import spec as tspec
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp
from tests.test_ring_control_loop import Q0, URDF_2DOF

T = 8
DT = 2.0 ** -6
ATOL = 1e-8
SETTINGS = dict(max_iters=10, max_qp_iters=30, termination_tolerance=1e-5,
                reg_init=1e-8)
YAML = (Path(__file__).resolve().parent.parent / "agimus_controller_tpu"
        / "ocp" / "definitions" / "ocp_traj_tracking_collision_avoidance.yaml")

# l2 at Q0 points along (sin -0.4, 0, cos -0.4); the sphere sits beside the
# capsule's mid point, 1.15 cm from its surface, on the side the tip goal
# of the `yaml` case turns it towards
_L2_MID = np.array([0.0700, 0.0, 0.4869])
_SIDE = np.array([-np.cos(0.4), 0.0, -np.sin(0.4)])
_SPHERE = _L2_MID + (0.03 + 0.05 + 0.0115) * _SIDE
URDF_COLL = URDF_2DOF.replace(
    '<link name="base"><inertial>',
    '<link name="base"><collision name="obstacle"><origin xyz="{:.6f} 0 '
    '{:.6f}"/><geometry><sphere radius="0.05"/></geometry></collision>'
    '<inertial>'.format(_SPHERE[0], _SPHERE[2])).replace(
    '<link name="l2"><inertial>',
    '<link name="l2"><collision name="l2_capsule"><origin xyz="0 0 0.12"/>'
    '<geometry><cylinder radius="0.03" length="0.2"/></geometry></collision>'
    '<inertial>')

# the tip goal offset (from the tip at Q0) and its weight, per case
GOALS = {"elbow_band": ([0.06, 0.0, -0.04], 1.0),
         "control_box": ([0.0, 0.0, 0.0], 1.0),
         "yaml": ([-0.06, 0.0, 0.0], 1e3)}
NC = {"elbow_band": 3, "control_box": 2, "yaml": 1}


def to_port_spec(s):
    """The port's ProblemSpec with the same items (constraints included)."""
    cost = lambda seq: tuple(tspec.CostItem(**dataclasses.asdict(i)) for i in seq)
    return tspec.ProblemSpec(
        running_costs=cost(s.running_costs), terminal_costs=cost(s.terminal_costs),
        constraints=tuple(tspec.ConstraintItem(**dataclasses.asdict(c))
                          for c in s.constraints),
        horizon=s.horizon, dt=s.dt, dt_factor_n_seq=s.dt_factor_n_seq)


def _jax_spec(name, jm):
    if name == "yaml":
        return jax_load_ocp_spec(YAML, jm, horizon=T, dt=DT,
                                 default_ee_frame="tip")
    C = jspec.CostItem
    con = {"elbow_band": jspec.ConstraintItem(
               name="elbow_band", kind="frame_translation", frame="l2",
               lower=(-0.01,) * 3, upper=(0.01,) * 3),
           "control_box": jspec.ConstraintItem(
               name="ubox", kind="control_limit", lower=(-1.3,) * 2,
               upper=(1.3,) * 2)}[name]
    return jspec.ProblemSpec(
        running_costs=(
            C(name="state_reg", kind="state", weight=0.1, update=True),
            C(name="ctrl", kind="control_grav", weight=1e-3),
            C(name="goal", kind="frame_placement", weight=10.0, update=True,
              frame="tip")),
        terminal_costs=(
            C(name="goal", kind="frame_placement", weight=100.0, update=True,
              frame="tip"),),
        constraints=(con,), horizon=T, dt=DT)


class Case:
    """One constrained spec on the 2-DoF arm, both packages."""

    def __init__(self, name):
        self.name = name
        jm, jp = jax_build(URDF_COLL, armature=np.array([0.1, 0.1]),
                           collision_pairs=[("l2_capsule", "obstacle")],
                           dtype=np.float64)
        self.jm, self.jp = jm, jp
        self.p = params_from_numpy(jp, dtype=torch.float64, device="cpu")
        self.js = _jax_spec(name, jm)
        self.ps = to_port_spec(self.js)
        self.cf = build_cost_functions(jm, jp, self.js, dtype=jnp.float64)
        q0 = jnp.asarray(Q0)
        self.x0 = np.concatenate([Q0, np.zeros(2)])
        self.tau_g = np.asarray(dynamics.rnea(jm, jp, q0, jnp.zeros(2),
                                              jnp.zeros(2)))
        self.R0, p0 = (np.asarray(a) for a in kinematics.frame_placement(
            jm, jp, q0, jm.frame_id("tip")))
        _, self.p_l2 = kinematics.frame_placement(jm, jp, q0, jm.frame_id("l2"))
        offset, self.w_goal = GOALS[name]
        self.goal = p0 + np.asarray(offset)

    # -- one batch solve -------------------------------------------------
    def refs(self):
        """The refs dict of a batch solve (numpy): neutral defaults, the
        state and control references at Q0, the tip goal and, for the elbow
        band, the band's centre `ee_trans:l2`."""
        refs = {k: np.array(v) for k, v in jspec.default_references(
            self.js, self.jm, dtype=jnp.float64).items()}
        refs["xref"] = np.tile(self.x0[None], (T + 1, 1))
        if "uref" in refs:
            refs["uref"] = np.tile(self.tau_g[None], (T + 1, 1))
        refs["ee_rot:tip"] = np.tile(self.R0[None], (T + 1, 1, 1))
        refs["ee_trans:tip"] = np.tile(self.goal[None], (T + 1, 1))
        refs["w_ee:tip"] = np.full((T + 1, 6), self.w_goal)
        if self.name == "elbow_band":
            refs["ee_trans:l2"] = np.tile(np.asarray(self.p_l2)[None],
                                          (T + 1, 1))
        return refs

    def start(self, B, seed):
        """(x0s [B, nx], xs [B, T+1, nx], us [B, T, nu]): perturbed initial
        states, the warm start at Q0 under gravity compensation."""
        rng = np.random.default_rng(seed)
        x0s = np.concatenate([Q0 + rng.normal(size=(B, 2)) * 0.02,
                              rng.normal(size=(B, 2)) * 0.05], 1)
        xs = np.tile(self.x0[None, None], (B, T + 1, 1))
        us = np.tile(self.tau_g[None, None], (B, T, 1))
        return x0s, xs, us

    def solve_both(self, B, seed=0):
        """(JAX solution, port solution) of one batch solve from the same
        inputs, with the same duals warm start y0."""
        refs = self.refs()
        x0s, xs, us = self.start(B, seed)
        y0 = np.random.default_rng(seed + 1).uniform(
            0.0, 0.1, (B, T + 1, NC[self.name]))
        solve = jax.jit(jax_make_batch_sqp(self.jm, self.jp, self.js, self.cf,
                                           JaxSettings(**SETTINGS)))
        ref = solve(jnp.asarray(x0s), {k: jnp.asarray(v) for k, v in refs.items()},
                    jnp.asarray(xs), jnp.asarray(us), None, jnp.asarray(y0))
        port = make_batch_sqp(self.jm, self.p, self.ps, CSQPSettings(**SETTINGS),
                              device="cpu")
        t = torch.as_tensor
        sol = port(t(x0s), refs_from_numpy(refs, device="cpu"), t(xs), t(us),
                   None, t(y0))
        return ref, sol

    # -- a chained fused-tick run ----------------------------------------
    def _point(self, i):
        """Streamed point i: the tip goal drifts along x with i."""
        pt = TrajectoryPoint(
            id=i, time_ns=int(i * DT * 1e9), robot_configuration=Q0.copy(),
            robot_velocity=np.zeros(2), robot_acceleration=np.zeros(2),
            robot_effort=self.tau_g.copy(),
            end_effector_poses={"tip": (self.R0, self.goal + np.asarray(
                [0.002 * (i % 5), 0.0, 0.0]))})
        w = TrajectoryPointWeights(
            w_robot_configuration=np.full(2, 0.5),
            w_robot_velocity=np.full(2, 1.0), w_robot_effort=np.ones(2),
            w_end_effector_poses={"tip": np.full(6, self.w_goal)})
        return WeightedTrajectoryPoint(point=pt, weights=w)

    def base_refs(self):
        """Refs outside the ring rows: the elbow band's centre."""
        refs = {k: v for k, v in self.refs().items() if k == "ee_trans:l2"}
        return refs

    def chain_both(self, n_ticks=4):
        """n_ticks fused ticks with a drifting measured state, the duals
        carried by each runner; returns [(JAX fetch, port fetch, JAX y,
        port y)] from the first solve on."""
        seq = DTFactorsNSeq(factors=[1], n_steps=[T])
        jbuf = JaxBuffer(seq, JaxRowLayout(self.js, self.jm), dtype=jnp.float64)
        pbuf = PackedTrajectoryBuffer(seq, RowLayout(self.ps, self.jm),
                                      dtype=torch.float64, device="cpu")
        for i in range(3 * T):
            jbuf.append(self._point(i))
            pbuf.append(self._point(i))
        base = self.base_refs()
        jrefs = dict(jspec.default_references(self.js, self.jm,
                                              dtype=jnp.float64))
        jrefs.update({k: jnp.asarray(v) for k, v in base.items()})
        prefs = tspec.default_references(self.ps, self.jm, dtype=torch.float64,
                                         device="cpu")
        prefs.update(refs_from_numpy(base, device="cpu"))
        jrun = JaxRunner(self.jm, self.jp, self.js, self.cf, jbuf.ring, jrefs,
                         JaxSettings(**SETTINGS), dtype=jnp.float64)
        prun = FusedTickRunner(self.jm, self.p, self.ps, pbuf.ring, prefs,
                               CSQPSettings(**SETTINGS), dtype=torch.float64,
                               device="cpu")
        xs0 = np.tile(self.x0[None], (T + 1, 1))
        us0 = np.tile(self.tau_g[None], (T, 1))
        jrun.initialize(self.x0, xs0, us0, limit=50)
        prun.initialize(self.x0, xs0, us0, limit=50)
        out = [(jrun.fetch(), prun.fetch(), np.asarray(jrun.last.y),
                prun.last.y.numpy())]
        rng = np.random.default_rng(0)
        for k in range(n_ticks):
            jbuf.append(self._point(3 * T + k))
            pbuf.append(self._point(3 * T + k))
            xk = self.x0 + np.concatenate([rng.normal(size=2) * 0.01,
                                           rng.normal(size=2) * 0.05])
            jrun.step(xk, limit=3)
            prun.step(xk, limit=3)
            out.append((jrun.fetch(), prun.fetch(), np.asarray(jrun.last.y),
                        prun.last.y.numpy()))
        return out


def assert_solutions_match(ref, sol):
    """Iterates, gains, duals and the solve's reports agree to ATOL; the
    iteration and ADMM counts and the convergence flags are equal."""
    for f in ("xs", "us", "K", "k", "y", "kkt", "cost", "gap_norm",
              "constraint_norm"):
        np.testing.assert_allclose(getattr(sol, f).numpy(),
                                   np.asarray(getattr(ref, f)), rtol=0,
                                   atol=ATOL, err_msg=f)
    for f in ("iters", "qp_iters", "converged"):
        np.testing.assert_array_equal(getattr(sol, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)


def assert_ticks_match(tick):
    """One tick of a chained run: the control message and the carried
    duals agree to ATOL; iteration counts and convergence are equal."""
    (jK0, ju0, jkkt, jit, jconv), (K0, u0, kkt, it, conv), jy, y = tick
    np.testing.assert_allclose(K0, jK0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(u0, ju0, rtol=0, atol=ATOL)
    np.testing.assert_allclose(y, jy, rtol=0, atol=ATOL)
    assert abs(kkt - jkkt) <= ATOL
    assert (it, conv) == (jit, jconv)
