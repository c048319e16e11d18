"""The port's plots (`plots/`), debugger (`runtime/debugger.py`) and meshcat
scene export (`runtime/meshcat_viz.py`) vs the JAX package, f64 on the CPU.

- `pin_utils`: end-effector positions, rotations, roll-pitch-yaw, linear
  and angular velocities and gravity torques along 12 random Panda states
  against JAX's at 1e-10;
- the plot dumps (`plot_values`, `plot_mpc_data`, the three-rate
  `plot_mpc_results` and `plot_tails` with their EE figures): the same
  files with the same JSON, values at 1e-10; the returned figure data too;
- `MPCDebugger` on `OCPTorch` against JAX's on `OCPJax` (the Panda goal
  spec of `test_debugger_tails.py`, T=5, a random prediction): running
  and terminal cost breakdowns, residual streams, the |dL/dx| heatmap and
  the EE path at 1e-10, and `test_debugger_tails.py`'s own checks; the
  tick-stream path and `LiveDebugView`'s frames (Agg);
- `scene_description` and `export_scene_json` against JAX's
  (`test_observability_tail.py::test_meshcat_scene_export` on the port).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.mpc.ocp_base import OCPJax
from agimus_controller_tpu.ocp.spec import CostItem as JCostItem
from agimus_controller_tpu.ocp.spec import ProblemSpec as JProblemSpec
from agimus_controller_tpu.plots import mpc_utils as jmpc_utils
from agimus_controller_tpu.plots import pin_utils as jpin
from agimus_controller_tpu.plots import plots_utils as jplots
from agimus_controller_tpu.runtime import meshcat_viz as jviz
from agimus_controller_tpu.runtime.debugger import MPCDebugger as JaxDebugger
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu_torch.mpc.data import MPCDebugData, OCPDebugData
from agimus_controller_tpu_torch.mpc.ocp_base import OCPTorch
from agimus_controller_tpu_torch.plots import mpc_utils, pin_utils, plots_utils
from agimus_controller_tpu_torch.plots.dump_utils import dump_filename
from agimus_controller_tpu_torch.runtime import meshcat_viz
from agimus_controller_tpu_torch.runtime.debugger import (
    LiveDebugView,
    MPCDebugger,
)
from tests.test_torch_soft_contact import port_spec

ATOL = 1e-10
FRAME = "panda_hand_tcp"


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(dtype=np.float64)
    pm, pp = load_panda(dtype=torch.float64, device="cpu")
    return jm, jp, pm, pp


def _states(n, seed):
    rng = np.random.default_rng(seed)
    qs = np.asarray(PANDA_Q_READY)[None] + rng.normal(size=(n, 7)) * 0.3
    return qs, rng.normal(size=(n, 7))


@pytest.mark.parametrize("fn", ["get_p_", "get_R_", "get_rpy_", "get_v_",
                                "get_w_", "get_u_grav"])
def test_pin_utils_match_jax(panda, fn):
    jm, jp, pm, pp = panda
    qs, vs = _states(12, 0)
    args = (qs,) if fn in ("get_p_", "get_R_", "get_rpy_", "get_u_grav") \
        else (qs, vs)
    frame = () if fn == "get_u_grav" else (FRAME,)
    got = getattr(pin_utils, fn)(*args, pm, pp, *frame)
    want = getattr(jpin, fn)(*args, jm, jp, *frame)
    assert isinstance(got, np.ndarray) and got.shape == np.shape(want)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


def _dumps(path):
    return {p.name: json.loads(p.read_text())
            for p in sorted(path.glob("*_plotdata.json"))}


def _numeric(x):
    try:
        return np.asarray(x, float)
    except (TypeError, ValueError):
        return None


def _same_json(got, want, name=""):
    """JSON documents equal: numbers at ATOL, everything else exactly."""
    if isinstance(want, dict):
        assert set(got) == set(want), name
        for k in want:
            _same_json(got[k], want[k], f"{name}.{k}")
    elif isinstance(want, list) and _numeric(want) is None:
        assert len(got) == len(want), name
        for i, (g, w) in enumerate(zip(got, want)):
            _same_json(g, w, f"{name}[{i}]")
    elif isinstance(want, list) and want and not isinstance(
            want[0], (str, bool)):
        np.testing.assert_allclose(_numeric(got), _numeric(want), rtol=0,
                                   atol=ATOL, err_msg=name)
    else:
        assert got == want, name


def _record_data():
    rng = np.random.default_rng(3)
    N = 6
    return {"time": np.arange(N) * 0.01,
            "solve_time_ns": rng.integers(1_000_000, 3_000_000, N),
            "kkt": rng.uniform(1e-6, 1e-3, N), "iters": np.arange(N),
            "qp_iters": 2 * np.arange(N),
            "collision_distances": rng.uniform(0.01, 0.1, (N, 2)),
            "vs_state": np.asarray([0, 0, 1, 1, 2, 0]),
            "vs_weights": rng.uniform(size=(N, 2)),
            "state_predictions": rng.normal(size=(N, 5, 14))}


def test_plot_dumps_match_jax(tmp_path):
    """`plot_values` and every `plot_mpc_data` figure: same files, same
    JSON (the schema of `PLOT_DATA_FORMAT.md`)."""
    t = np.linspace(0, 1, 50)
    vals = np.stack([np.sin(t), np.cos(t)], axis=1)
    which = ["computation_time", "collision_distance", "iter",
             "visual_servoing", "predictions"]
    for pkg, mod in (("jax", jplots), ("port", plots_utils)):
        out = tmp_path / pkg
        out.mkdir()
        mod.plot_values("my plot", vals, t, labels=["a", "b"],
                        dump_path=str(out))
        mod.plot_mpc_data(_record_data(), which_plots=which,
                          dump_path=str(out))
    got, want = _dumps(tmp_path / "port"), _dumps(tmp_path / "jax")
    assert set(got) == set(want) and len(got) == 6
    _same_json(got, want)
    data = got["my_plot_plotdata.json"]
    assert data["labels"] == ["a", "b"] and len(data["values"]) == 2
    assert dump_filename(tmp_path, "my plot").name == "my_plot_plotdata.json"


def _three_rate(mod, T=6, nx=14, nu=7):
    sd = mod.init_sim_data(T, nx, nu, dt_plan=0.02, dt_mpc=0.01,
                           dt_sim=0.002, duration=0.1)
    rng = np.random.default_rng(3)
    for _ in range(sd["N_plan"]):
        mod.record_plan(sd, rng.normal(size=(T + 1, nx)),
                        rng.normal(size=(T, nu)))
        for _ in range(2):
            mod.record_mpc(sd, rng.normal(size=nx), rng.normal(size=nu))
            for _ in range(5):
                mod.record_sim(sd, rng.normal(size=nx))
    return sd


def test_three_rate_results_match_jax(tmp_path, panda):
    """`init_sim_data`, the extraction and `plot_mpc_results` with the EE
    figures (over `pin_utils`), against JAX's; the mirrored checks of
    `test_observability_tail.py::test_three_rate_sim_data`."""
    jm, jp, pm, pp = panda
    figs = {}
    for pkg, mod, model in (("jax", jmpc_utils, (jm, jp)),
                            ("port", mpc_utils, (pm, pp))):
        out = tmp_path / pkg
        out.mkdir()
        pd = mod.extract_plot_data_from_sim_data(_three_rate(mod))
        figs[pkg] = mod.plot_mpc_results(pd, *model, ee_frame=FRAME,
                                         dump_path=str(out))
    _same_json(figs["port"], figs["jax"])
    _same_json(_dumps(tmp_path / "port"), _dumps(tmp_path / "jax"))
    pd = mpc_utils.extract_plot_data_from_sim_data(_three_rate(mpc_utils))
    assert pd["q_measured"].shape == (50, 7)
    assert pd["x_pred_interp_mpc"].shape == (10, 14)
    assert {"state q", "control u", "ee position",
            "ee angular velocity"} <= set(figs["port"])
    with pytest.raises(ValueError):
        mpc_utils.init_sim_data(4, 14, 7, dt_plan=0.02, dt_mpc=0.015,
                                dt_sim=0.001, duration=0.1)


def test_plot_tails_match_jax(tmp_path, panda):
    """`test_debugger_tails.py::test_plot_tails` on the port, against
    JAX's figures and dumps."""
    jm, jp, pm, pp = panda
    N, T1 = 12, 6
    rng = np.random.default_rng(0)
    xs = np.tile(np.concatenate([PANDA_Q_READY, np.zeros(7)]), (N, T1, 1))
    xs += 0.01 * rng.normal(size=xs.shape)
    us = rng.normal(size=(N, T1 - 1, 7))
    figs = {}
    for pkg, mod, m, p in (("jax", jmpc_utils, jm, jp),
                           ("port", mpc_utils, pm, pp)):
        (tmp_path / pkg).mkdir()
        figs[pkg] = mod.plot_tails(xs, us, dt=0.01, model=m, params=p,
                                   ee_frame=FRAME,
                                   dump_path=str(tmp_path / pkg))
    got = figs["port"]
    assert set(got) == {"state q", "state v", "control u", "ee position",
                        "ee orientation rpy", "ee angular velocity"}
    assert len(got["state q"]["tails"]) == 2
    assert np.asarray(got["ee position"]["measured"]).shape == (N, 3)
    _same_json(got, figs["jax"])
    _same_json(_dumps(tmp_path / "port"), _dumps(tmp_path / "jax"))


# -- the debugger --------------------------------------------------------------
T_DBG = 5


def _debug_spec():
    return JProblemSpec(
        running_costs=(
            JCostItem(name="state_reg", kind="state", weight=0.1,
                      update=True),
            JCostItem(name="ctrl_reg", kind="control", weight=1e-2,
                      update=True),
            JCostItem(name="goal", kind="frame_placement", weight=10.0,
                      update=True, frame=FRAME, publish_residual=True),
        ),
        terminal_costs=(
            JCostItem(name="goal", kind="frame_placement", weight=50.0,
                      update=True, frame=FRAME),
        ),
        horizon=T_DBG, dt=0.01)


@pytest.fixture(scope="module")
def debuggers(panda):
    jm, jp, pm, pp = panda
    js = _debug_spec()
    jocp = OCPJax(jm, jp, js, dtype=jnp.float64)
    pocp = OCPTorch(pm, pp, port_spec(js), dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(4)
    x0 = np.concatenate([PANDA_Q_READY, np.zeros(7)])
    xs = np.tile(x0, (T_DBG + 1, 1)) + rng.normal(size=(T_DBG + 1, 14)) * 0.1
    us = rng.normal(size=(T_DBG, 7))
    return (JaxDebugger(jocp), MPCDebugger(pocp), xs, us,
            np.tile(x0, (T_DBG + 1, 1)))


def test_debugger_evaluate_matches_jax(debuggers):
    jdbg, dbg, xs, us, _ = debuggers
    got, want = dbg.evaluate(xs, us), jdbg.evaluate(xs, us)
    for part in ("running_costs", "terminal_costs", "residuals"):
        assert set(got[part]) == set(want[part]), part
        for k in want[part]:
            np.testing.assert_allclose(np.asarray(got[part][k]),
                                       np.asarray(want[part][k]), rtol=0,
                                       atol=ATOL, err_msg=f"{part} {k}")
    np.testing.assert_allclose(got["grad_heatmap"], want["grad_heatmap"],
                               rtol=0, atol=ATOL)
    assert got["grad_heatmap"].shape == (T_DBG, 14)


def test_debugger_ee_path_matches_jax(debuggers):
    jdbg, dbg, xs, _, _ = debuggers
    np.testing.assert_allclose(dbg.ee_path(xs, FRAME),
                               jdbg.ee_path(xs, FRAME), rtol=0, atol=ATOL)


def test_debugger_cost_breakdown(debuggers):
    """`test_debugger_tails.py::test_debugger_cost_breakdown` and
    `test_debugger_ee_path` on the port."""
    _, dbg, _, _, xs = debuggers
    out = dbg.evaluate(xs, np.zeros((T_DBG, 7)))
    assert set(out["running_costs"]) == {"state_reg", "ctrl_reg", "goal"}
    assert out["running_costs"]["goal"].shape == (T_DBG,)
    assert set(out["terminal_costs"]) == {"goal"}
    assert np.all(out["running_costs"]["goal"]
                  > out["running_costs"]["ctrl_reg"])
    assert out["residuals"]["goal"].shape == (T_DBG, 6)
    assert np.all(np.isfinite(out["grad_heatmap"]))
    path = dbg.ee_path(xs, FRAME)
    assert path.shape == (T_DBG + 1, 3)
    np.testing.assert_allclose(path, np.tile(path[0], (len(path), 1)),
                               atol=1e-12)


def test_debugger_breakdown_sums_to_the_cost(debuggers):
    """The breakdown, dt-scaled on the running nodes, sums to the OCP's
    cost of the prediction (`CostFunctions.value` + `term_value`)."""
    _, dbg, xs, us, _ = debuggers
    out = dbg.evaluate(xs, us)
    cf, ocp = dbg._cf, dbg._ocp
    t = torch.as_tensor
    dts = ocp.spec.timesteps()
    total = (sum(float(np.sum(v * dts)) for v in
                 out["running_costs"].values())
             + sum(out["terminal_costs"].values()))
    want = float(cf.value(t(xs[:-1]), t(us), torch.arange(T_DBG),
                          ocp.refs).sum()
                 + cf.term_value(t(xs[-1:]), ocp.refs).sum())
    assert abs(total - want) <= 1e-10 * abs(want)


def test_streams_from_tick():
    dbg = MPCDebugData(ocp=OCPDebugData(references={"goal": np.ones(3)},
                                        residuals={"goal": np.zeros(6)}))
    got = MPCDebugger.streams_from_tick(dbg)
    assert set(got) == {"references", "residuals"}
    assert MPCDebugger.streams_from_tick(MPCDebugData(ocp=OCPDebugData())) \
        is None
    assert MPCDebugger.streams_from_tick(MPCDebugData()) is None


def test_live_debug_view_renders_frames(tmp_path, debuggers):
    _, dbg, xs, us, _ = debuggers
    view = LiveDebugView(dbg, ee_frame=FRAME)
    K = 3
    rng = np.random.default_rng(2)
    paths = view.render_run(xs[None].repeat(K, 0)
                            + rng.normal(size=(K,) + xs.shape) * 0.01,
                            us[None].repeat(K, 0), tmp_path / "frames")
    view.close()
    assert len(paths) == K
    assert all(p.exists() and p.stat().st_size > 1000 for p in paths)


# -- meshcat scene -------------------------------------------------------------
def test_meshcat_scene_matches_jax(tmp_path):
    from tests.test_robot_models import ENV_URDF

    pair = [("panda_link7_capsule", "obstacle_sphere")]
    jm, jp = jax_load_panda(dtype=np.float64, env_urdf=ENV_URDF,
                            collision_pairs=pair)
    pm, pp = load_panda(dtype=torch.float64, device="cpu", env_urdf=ENV_URDF,
                        collision_pairs=pair)
    qs = np.tile(np.asarray(PANDA_Q_READY), (4, 1))
    qs[1:, 0] += np.linspace(0.1, 0.3, 3)
    doc = meshcat_viz.export_scene_json(pm, pp, qs, tmp_path / "scene.json",
                                        every=2)
    want = jviz.export_scene_json(jm, jp, qs, tmp_path / "jax.json", every=2)
    assert meshcat_viz.scene_description(pm, pp) == \
        jviz.scene_description(jm, jp)
    assert len(doc["frames"]) == 2
    assert len(doc["geometries"]) == len(pm.geometries) > 0
    assert all(g["type"] in ("sphere", "capsule") for g in doc["geometries"])
    assert json.loads((tmp_path / "scene.json").read_text()) == doc
    _same_json(doc, want)
    f0 = np.asarray(doc["frames"][0][-2]["trans"])
    f1 = np.asarray(doc["frames"][1][-2]["trans"])
    assert np.any(np.abs(f0 - f1) > 1e-6)  # a link geometry moved
    with pytest.raises(ImportError, match="meshcat"):
        meshcat_viz.MeshcatReplay(pm, pp)
