"""Plot dispatcher over recorded MPC data (reference:
`plots/plots_utils.py:13-293`). Works headless: when matplotlib is absent or
``show=False``, only the JSON sidecars are produced (same filenames/schema as
the reference).

Port of the JAX package's `plots/plots_utils.py` (numpy and matplotlib; a
copy). Without matplotlib `_maybe_plt` returns None and only the JSON dumps
are written."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .dump_utils import dump_filename, dump_plot_data


def _maybe_plt():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_values(
    title: str,
    values_array,
    time,
    labels=None,
    ylabels=None,
    semilogs=None,
    ylimits=None,
    dump_path: Optional[str] = None,
    show: bool = False,
):
    """Subplots from a [N, k] array of series (reference `plot_values`);
    always dumps the JSON sidecar when ``dump_path`` is given."""
    values_array = np.asarray(values_array)
    if values_array.ndim == 1:
        values_array = values_array[:, None]
    time = np.asarray(time)
    colors = []
    plt = _maybe_plt() if (show or dump_path) else None
    if plt is not None and show:
        fig, axes = plt.subplots(values_array.shape[1], 1, squeeze=False)
        for i in range(values_array.shape[1]):
            ax = axes[i][0]
            plot_fn = ax.semilogy if (semilogs and semilogs[i]) else ax.plot
            (line,) = plot_fn(time, values_array[:, i],
                              label=labels[i] if labels else None)
            colors.append(line.get_color())
            if labels:
                ax.legend()
            ax.set_xlabel("t (s)")
            if ylimits:
                ax.set_ylim(*ylimits[i])
        fig.canvas.manager.set_window_title(title)
    if dump_path is not None:
        dump_plot_data(
            dump_filename(dump_path, title), title, time, values_array.T,
            labels=labels, ylabels=ylabels, semilogs=semilogs,
            ylimits=ylimits, colors=colors,
        )


def plot_mpc_data(
    mpc_data: Dict,
    which_plots: Optional[List[str]] = None,
    dump_path: Optional[str] = None,
    show: bool = False,
):
    """Dispatch standard MPC diagnostic plots (reference `plot_mpc_data`,
    `plots_utils.py:148-293`).

    ``mpc_data`` keys (all optional, produced by the runtime recorder):
      time [N], solve_time_ns [N], kkt [N], iters [N], qp_iters [N],
      collision_distances [N, n_pairs], state_predictions [N, T+1, nx],
      control_predictions [N, T, nu].
    """
    which = which_plots or [
        "computation_time", "collision_distance", "iter", "visual_servoing"]
    t = np.asarray(mpc_data.get("time", np.arange(len(mpc_data.get("solve_time_ns", [])))))

    if "computation_time" in which and "solve_time_ns" in mpc_data:
        st = np.asarray(mpc_data["solve_time_ns"]) / 1e6
        plot_values(
            "computation time", st, t, labels=["solve time (ms)"],
            dump_path=dump_path, show=show,
        )
    if "collision_distance" in which and "collision_distances" in mpc_data:
        d = np.asarray(mpc_data["collision_distances"])
        plot_values(
            "collision distance", d, t,
            labels=[f"pair {i}" for i in range(d.shape[1])],
            dump_path=dump_path, show=show,
        )
    if "iter" in which and "kkt" in mpc_data:
        vals = np.stack(
            [np.asarray(mpc_data["kkt"]),
             np.asarray(mpc_data.get("iters", np.zeros_like(t))),
             np.asarray(mpc_data.get("qp_iters", np.zeros_like(t)))], axis=1)
        plot_values(
            "iter", vals, t, labels=["kkt", "iters", "qp_iters"],
            semilogs=[True, False, False], dump_path=dump_path, show=show,
        )
    if "visual_servoing" in which and (
            "vs_state" in mpc_data or "vs_weights" in mpc_data):
        # reference `plot_mpc_data` visual-servoing section
        # (`plots_utils.py:148-293`): reconstructed state-machine phase
        # (IDLE / USING_VISUAL_SERVOING / COMING_BACK_TO_IDLE) + the tanh
        # translation-weight ramp over the run
        series = []
        labels = []
        if "vs_state" in mpc_data:
            series.append(np.asarray(mpc_data["vs_state"], dtype=float))
            labels.append("vs state (0=idle 1=vs 2=return)")
        if "vs_weights" in mpc_data:
            w = np.asarray(mpc_data["vs_weights"])
            if w.ndim == 1:
                w = w[:, None]
            for j in range(w.shape[1]):
                series.append(w[:, j])
                labels.append(f"vs weight {j}")
        plot_values(
            "visual servoing", np.stack(series, axis=1), t, labels=labels,
            dump_path=dump_path, show=show,
        )
    if "predictions" in which and "state_predictions" in mpc_data:
        xs = np.asarray(mpc_data["state_predictions"])  # [N, T+1, nx]
        plot_values(
            "predictions x0", xs[:, 0, :], t, dump_path=dump_path, show=show,
        )
