"""MPC debugger: re-evaluate per-cost values/residuals over received
predictions (reference `MPCDebuggerNode`,
`agimus_controller_ros/mpc_debugger_node.py:82-679`).

The reference rebuilds the controller's OCP from its ROS params and re-runs
Crocoddyl calc/calcDiff on each received prediction to produce a live per-cost
bar chart + cost-Jacobian heatmap; here the same data comes from one
node-batched `cost_breakdown_b` pass plus `torch.func.grad` of the summed
stage costs (the nodes are independent, so each node's row is its own
gradient). EE-path extraction for markers is one FK call vmapped over the
nodes (reference FK-projected MarkerArrays `:555-611`).

Port of the JAX package's `runtime/debugger.py` over `OCPTorch`; the
prediction is evaluated on the OCP's device and read back once per result.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..mpc.ocp_base import OCPTorch
from ..ops import kinematics


class MPCDebugger:
    def __init__(self, ocp: OCPTorch):
        self._ocp = ocp
        self._cf = ocp._cf
        self._model = ocp._model
        self._params = ocp._params
        self._T = ocp.spec.horizon
        self._ts = {}  # device -> node times [T]

    def _tensors(self, xs, us):
        o = self._ocp
        kw = dict(dtype=o._dtype, device=o.device)
        xs, us = torch.as_tensor(xs, **kw), torch.as_tensor(us, **kw)
        if o.device not in self._ts:
            self._ts[o.device] = torch.arange(self._T, device=o.device)
        return xs, us, self._ts[o.device]

    def breakdown(self, xs, us, refs):
        """({item: weighted value [T]} of the running items, {item: value}
        of the terminal items), unscaled by dt as `cost_breakdown`."""
        xs, us, ts = self._tensors(xs, us)
        run = {k: v[0] for k, v in self._cf.cost_breakdown_b(
            xs[:-1], us, ts, refs).items()}
        term = {k: v[0] for k, v in self._cf.cost_breakdown(
            xs[-1], torch.zeros_like(us[0]), self._T, refs,
            terminal=True).items()}
        return run, term

    def residuals(self, xs, us, refs):
        """{item: residual [T, r]} of the running items."""
        xs, us, ts = self._tensors(xs, us)
        return {k: v[1] for k, v in self._cf.cost_breakdown_b(
            xs[:-1], us, ts, refs).items()}

    def grad_heatmap(self, xs, us, refs):
        """|d(stage cost)/dx| per node, [T, nx] — the normalized
        cost-Jacobian heatmap of the reference (`_init_cost_plot`,
        `:330-379`)."""
        xs, us, ts = self._tensors(xs, us)
        g = torch.func.grad(
            lambda x: self._cf.value(x, us, ts, refs).sum())(xs[:-1])
        return g.abs()

    def evaluate(self, xs: np.ndarray, us: np.ndarray) -> Dict:
        """Per-cost running values [T], terminal values, residual streams and
        the |dL/dx| heatmap for a prediction (xs [T+1,nx], us [T,nu])."""
        refs = self._ocp.refs
        run, term = self.breakdown(xs, us, refs)
        res = self.residuals(xs, us, refs)
        heat = self.grad_heatmap(xs, us, refs)
        host = lambda v: v.detach().cpu().numpy()
        return {
            "running_costs": {k: host(v) for k, v in run.items()},
            "terminal_costs": {k: float(v) for k, v in term.items()},
            "residuals": {k: host(v) for k, v in res.items()},
            "grad_heatmap": host(heat),
        }

    @staticmethod
    def streams_from_tick(debug) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
        """Consume the per-tick named reference/residual streams the OCP
        already published (`OCPDebugData.references/residuals`, filled by
        `OCPTorch` when `use_debug_data` is on) WITHOUT re-evaluating the
        OCP — the reference's MpcDebug-message consumption path
        (`ros_utils.py:295-317`). Returns None when the tick carried no
        streams (fall back to `evaluate`)."""
        ocp_dbg = getattr(debug, "ocp", debug)
        if ocp_dbg is None or not (ocp_dbg.references or ocp_dbg.residuals):
            return None
        return {
            "references": dict(ocp_dbg.references),
            "residuals": dict(ocp_dbg.residuals),
        }

    def ee_path(self, xs: np.ndarray, frame: str) -> np.ndarray:
        """FK-projected EE positions of a predicted state path, [T+1, 3]
        (the RViz prediction-marker data)."""
        fid = self._model.frame_id(frame)
        o = self._ocp
        qs = torch.as_tensor(np.asarray(xs)[:, : self._model.nq],
                             dtype=o._dtype, device=o.device)
        p = torch.func.vmap(lambda q: kinematics.frame_placement(
            self._model, self._params, q, fid)[1])(qs)
        return p.cpu().numpy()


class LiveDebugView:
    """Live rendering of the debugger data: animated per-cost bar chart,
    normalized |dL/dx| heatmap and the FK-projected EE prediction path —
    the reference's matplotlib animation + RViz marker stream
    (`mpc_debugger_node.py:269-379` cost plots, `:450-611` markers).

    Interactive sessions get a redrawing figure (`update` + `plt.pause`);
    headless runs render each tick to a PNG under ``out_dir``
    (`render_run`), which is also what the tests exercise. Needs
    matplotlib.
    """

    def __init__(self, debugger: MPCDebugger, ee_frame: Optional[str] = None,
                 interactive: bool = False):
        import matplotlib

        if not interactive:
            matplotlib.use("Agg", force=True)
        import matplotlib.pyplot as plt

        self._plt = plt
        self._dbg = debugger
        self._frame = ee_frame
        self._interactive = interactive
        ncols = 3 if ee_frame else 2
        self._fig, axes = plt.subplots(1, ncols, figsize=(5 * ncols, 4))
        self._ax_bar, self._ax_heat = axes[0], axes[1]
        self._ax_ee = axes[2] if ee_frame else None
        self._bars = None
        self._im = None
        self._ee_line = None

    def update(self, xs: np.ndarray, us: np.ndarray) -> Dict:
        """Re-evaluate the OCP on a received prediction and redraw."""
        data = self._dbg.evaluate(xs, us)
        names = list(data["running_costs"].keys())
        totals = [float(np.sum(v)) for v in data["running_costs"].values()]
        if self._bars is None:
            self._bars = self._ax_bar.bar(range(len(names)), totals)
            self._ax_bar.set_xticks(range(len(names)))
            self._ax_bar.set_xticklabels(names, rotation=30, ha="right")
            self._ax_bar.set_title("running cost per term")
        else:
            for b, v in zip(self._bars, totals):
                b.set_height(v)
            self._ax_bar.relim()
            self._ax_bar.autoscale_view()
        heat = data["grad_heatmap"]
        norm = heat / (np.max(heat) + 1e-12)
        if self._im is None:
            self._im = self._ax_heat.imshow(
                norm.T, aspect="auto", origin="lower", cmap="viridis")
            self._ax_heat.set_title("|dL/dx| (normalized)")
            self._ax_heat.set_xlabel("node")
            self._ax_heat.set_ylabel("state dim")
        else:
            self._im.set_data(norm.T)
        if self._ax_ee is not None:
            path = self._dbg.ee_path(xs, self._frame)
            if self._ee_line is None:
                (self._ee_line,) = self._ax_ee.plot(path[:, 0], path[:, 2],
                                                    "o-", ms=2)
                self._ax_ee.set_title(f"EE prediction path ({self._frame})")
                self._ax_ee.set_xlabel("x [m]")
                self._ax_ee.set_ylabel("z [m]")
            else:
                self._ee_line.set_data(path[:, 0], path[:, 2])
                self._ax_ee.relim()
                self._ax_ee.autoscale_view()
        if self._interactive:
            self._plt.pause(0.001)
        return data

    def render_run(self, state_predictions: np.ndarray,
                   control_predictions: np.ndarray, out_dir,
                   every: int = 1) -> list:
        """Render a recorded run ([K, T+1, nx], [K, T, nu]) frame-by-frame
        to PNGs; returns the written paths (the offline-animation mode)."""
        from pathlib import Path

        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        paths = []
        for k in range(0, state_predictions.shape[0], every):
            self.update(state_predictions[k], control_predictions[k])
            p = out / f"debug_{k:05d}.png"
            self._fig.savefig(p, dpi=60)
            paths.append(p)
        return paths

    def close(self):
        self._plt.close(self._fig)
