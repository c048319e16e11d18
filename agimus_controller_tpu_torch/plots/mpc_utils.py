"""MPC sim-data plotting with prediction "tails" (reference:
`plots/mpc_utils.py:26-1503` + the rosbag adapter `plots/plot_tails.py:29-115`).

Takes recorded predictions (mpc_xs [N, T+1, nx], mpc_us [N, T, nu]) and the
measured closed-loop path, overlays subsampled prediction tails on the
measured trajectories for state / control / EE-position figures, headless by
default (JSON sidecars always dumped when ``dump_path`` is set).

Port of the JAX package's `plots/mpc_utils.py` (numpy and matplotlib; a
copy), its EE figures over the port's `pin_utils`."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .dump_utils import dump_filename, dump_plot_data
from .pin_utils import get_p_
from .plots_utils import _maybe_plt


def init_sim_data(T: int, nx: int, nu: int, *, dt_plan: float,
                  dt_mpc: float, dt_sim: float, duration: float) -> Dict:
    """Pre-allocated three-rate simulation arrays (reference
    `init_sim_data`, `mpc_utils.py:26-111`): planning/OCP rate for the
    prediction matrices, MPC rate for applied controls and measured ticks,
    SIM rate for the high-rate simulator measurements.  Fill with
    `record_plan` / `record_mpc` / `record_sim`."""
    for name, fine, coarse in (("dt_mpc/dt_plan", dt_mpc, dt_plan),
                               ("dt_sim/dt_mpc", dt_sim, dt_mpc)):
        ratio = coarse / fine
        if abs(ratio - round(ratio)) > 1e-9:
            raise ValueError(f"{name} must divide evenly, got {ratio}")
    N_plan = int(round(duration / dt_plan))
    N_mpc = int(round(duration / dt_mpc))
    N_sim = int(round(duration / dt_sim))
    return {
        "T": T, "nx": nx, "nu": nu,
        "dt_plan": dt_plan, "dt_mpc": dt_mpc, "dt_sim": dt_sim,
        "N_plan": N_plan, "N_mpc": N_mpc, "N_sim": N_sim,
        "state_pred": np.zeros((N_plan, T + 1, nx)),
        "ctrl_pred": np.zeros((N_plan, T, nu)),
        "state_ref": np.zeros((N_plan, nx)),
        "x_mea_MPC": np.zeros((N_mpc + 1, nx)),
        "u_app_MPC": np.zeros((N_mpc, nu)),
        "x_mea_SIM": np.zeros((N_sim + 1, nx)),
        "_i_plan": 0, "_i_mpc": 0, "_i_sim": 0,
    }


def record_plan(sd: Dict, xs_pred, us_pred, x_ref=None) -> None:
    i = sd["_i_plan"]
    sd["state_pred"][i] = np.asarray(xs_pred)
    sd["ctrl_pred"][i] = np.asarray(us_pred)
    if x_ref is not None:
        sd["state_ref"][i] = np.asarray(x_ref)
    sd["_i_plan"] = i + 1


def record_mpc(sd: Dict, x_mea, u_applied) -> None:
    i = sd["_i_mpc"]
    sd["x_mea_MPC"][i] = np.asarray(x_mea)
    sd["u_app_MPC"][i] = np.asarray(u_applied)
    sd["_i_mpc"] = i + 1


def record_sim(sd: Dict, x_mea) -> None:
    i = sd["_i_sim"]
    sd["x_mea_SIM"][i] = np.asarray(x_mea)
    sd["_i_sim"] = i + 1


def _is_three_rate(d: Dict) -> bool:
    return "x_mea_SIM" in d


def extract_plot_data_from_sim_data(mpc_data: Dict, dt: float = None) -> Dict:
    """Recorder dict OR three-rate sim-data -> plotting arrays (reference
    `extract_plot_data_from_sim_data`, `mpc_utils.py:113`).

    Three-rate inputs get: measured curves at SIM rate, applied controls at
    MPC rate (zero-order hold up to SIM rate for the overlay), prediction
    tails at the planning rate — plus the x0*/x1* interpolation of the
    first prediction interval at MPC ticks (`plot_tails.py:29-115`)."""
    if _is_three_rate(mpc_data):
        sd = mpc_data
        xs = np.asarray(sd["state_pred"])[:sd["_i_plan"]]
        us = np.asarray(sd["ctrl_pred"])[:sd["_i_plan"]]
        N, T1, nx = xs.shape
        nq = nx // 2
        n_sim = sd["_i_sim"]
        n_mpc = sd["_i_mpc"]
        x_sim = sd["x_mea_SIM"][:n_sim]
        t_sim = np.arange(n_sim) * sd["dt_sim"]
        # zero-order hold of MPC controls onto the SIM axis
        hold = max(1, int(round(sd["dt_mpc"] / sd["dt_sim"])))
        u_mpc = sd["u_app_MPC"][:n_mpc]
        u_sim = np.repeat(u_mpc, hold, axis=0)[:n_sim]
        # x0*/x1* interpolation: first prediction interval sampled at the
        # MPC ticks inside one planning period
        sub = max(1, int(round(sd["dt_plan"] / sd["dt_mpc"])))
        alphas = (np.arange(sub) / sub)[None, :, None]
        x01 = (1 - alphas) * xs[:, 0:1, :] + alphas * xs[:, 1:2, :]
        x_interp_mpc = x01.reshape(N * sub, nx)[:n_mpc]
        return {
            "N": N, "T": T1 - 1, "nq": nq, "dt": sd["dt_plan"],
            "time": t_sim,
            "q_measured": x_sim[:, :nq],
            "v_measured": x_sim[:, nq:2 * nq],
            "u_applied": u_sim,
            "xs_pred": xs, "us_pred": us,
            "time_mpc": np.arange(n_mpc) * sd["dt_mpc"],
            "x_pred_interp_mpc": x_interp_mpc,
            "tail_stride": max(1, int(round(sd["dt_plan"] / sd["dt_sim"]))),
        }
    xs = np.asarray(mpc_data["state_predictions"])  # [N, T+1, nx]
    us = np.asarray(mpc_data["control_predictions"])  # [N, T, nu]
    N, T1, nx = xs.shape
    nq = nx // 2
    return {
        "N": N,
        "T": T1 - 1,
        "nq": nq,
        "dt": dt,
        "time": np.arange(N) * dt,
        "q_measured": xs[:, 0, :nq],
        "v_measured": xs[:, 0, nq:2 * nq],
        "u_applied": us[:, 0, :],
        "xs_pred": xs,
        "us_pred": us,
    }


def _tails(values_pred: np.ndarray, dt: float, every: int):
    """Subsampled prediction tails: [(t_axis, tail_values), ...]."""
    out = []
    for i in range(0, values_pred.shape[0], every):
        t_axis = (i + np.arange(values_pred.shape[1])) * dt
        out.append((t_axis, values_pred[i]))
    return out


def plot_mpc_results(
    plot_data: Dict,
    model=None,
    params=None,
    ee_frame: Optional[str] = None,
    tail_every: int = 10,
    dump_path: Optional[str] = None,
    show: bool = False,
) -> Dict:
    """State/control/EE figures with prediction tails (reference
    `plot_mpc_results`, `mpc_utils.py:263` -> `:387/:600/:748`).

    Returns the assembled figure data (also dumped as JSON sidecars)."""
    t = plot_data["time"]
    dt = plot_data["dt"]
    nq = plot_data["nq"]
    figures = {}

    def assemble(title, measured, pred, labels):
        tails = _tails(pred, dt, tail_every)
        data = {
            "title": title,
            "time": t.tolist(),
            "measured": measured.tolist(),
            "labels": labels,
            "tails": [
                {"time": ta.tolist(), "values": tv.tolist()} for ta, tv in tails
            ],
        }
        figures[title] = data
        if dump_path is not None:
            dump_plot_data(
                dump_filename(dump_path, title), title, t, measured.T,
                labels=labels,
            )
        plt = _maybe_plt() if show else None
        if plt is not None:
            k = measured.shape[1]
            fig, axes = plt.subplots(k, 1, squeeze=False, figsize=(8, 2 * k))
            for j in range(k):
                ax = axes[j][0]
                for ta, tv in tails:
                    ax.plot(ta, tv[:, j], color="0.8", lw=0.6)
                ax.plot(t, measured[:, j], color="C0", lw=1.5, label=labels[j])
                ax.legend(loc="upper right")
            fig.suptitle(title)
            fig.savefig(str(dump_filename(dump_path or ".", title)).replace(
                "_plotdata.json", ".png"))
            plt.close(fig)
        return data

    assemble(
        "state q", plot_data["q_measured"], plot_data["xs_pred"][..., :nq],
        [f"q{j}" for j in range(nq)],
    )
    assemble(
        "state v", plot_data["v_measured"], plot_data["xs_pred"][..., nq:2 * nq],
        [f"v{j}" for j in range(nq)],
    )
    assemble(
        "control u", plot_data["u_applied"], plot_data["us_pred"],
        [f"u{j}" for j in range(plot_data["u_applied"].shape[1])],
    )
    if model is not None and ee_frame is not None:
        from .pin_utils import get_rpy_, get_w_

        p_meas = get_p_(plot_data["q_measured"], model, params, ee_frame)
        N, T1 = plot_data["xs_pred"].shape[:2]
        q_pred_flat = plot_data["xs_pred"][..., :nq].reshape(N * T1, nq)
        v_pred_flat = plot_data["xs_pred"][..., nq:2 * nq].reshape(N * T1, nq)
        p_pred = get_p_(q_pred_flat, model, params, ee_frame).reshape(N, T1, 3)
        assemble("ee position", p_meas, p_pred, ["x", "y", "z"])
        # EE angular figure suite (reference `plot_mpc_ee_angular`,
        # `plots/mpc_utils.py:1116`): orientation as RPY + angular velocity
        rpy_meas = get_rpy_(plot_data["q_measured"], model, params, ee_frame)
        rpy_pred = get_rpy_(q_pred_flat, model, params,
                            ee_frame).reshape(N, T1, 3)
        assemble("ee orientation rpy", rpy_meas, rpy_pred,
                 ["roll", "pitch", "yaw"])
        w_meas = get_w_(plot_data["q_measured"], plot_data["v_measured"],
                        model, params, ee_frame)
        w_pred = get_w_(q_pred_flat, v_pred_flat, model, params,
                        ee_frame).reshape(N, T1, 3)
        assemble("ee angular velocity", w_meas, w_pred, ["wx", "wy", "wz"])
    # force figure suite (reference `plot_mpc_force`, `plots/mpc_utils.py:1321`):
    # present when the state is force-augmented (x = [q; v; f], soft contact)
    nx = plot_data["xs_pred"].shape[2]
    ncf = nx - 2 * nq
    if ncf > 0:
        f_pred = plot_data["xs_pred"][..., 2 * nq:]
        f_meas = f_pred[:, 0, :]
        assemble("ee contact force", f_meas, f_pred,
                 [f"f{ax}" for ax in ("x", "y", "z")[:ncf]] if ncf <= 3
                 else [f"f{j}" for j in range(ncf)])
    return figures


def plot_tails(
    mpc_xs: np.ndarray,
    mpc_us: np.ndarray,
    dt: float,
    model=None,
    params=None,
    ee_frame: Optional[str] = None,
    dump_path: Optional[str] = None,
    show: bool = False,
) -> Dict:
    """Adapter from raw prediction arrays (the reference `plot_tails`
    rosbag-array entry point, `plot_tails.py:29-115`)."""
    plot_data = extract_plot_data_from_sim_data(
        {"state_predictions": mpc_xs, "control_predictions": mpc_us}, dt)
    return plot_mpc_results(plot_data, model=model, params=params,
                            ee_frame=ee_frame, dump_path=dump_path, show=show)
