"""MPC telemetry recorder: the rosbag-record analog (reference checkpoint/
resume substitute, SURVEY.md §5: `/ocp_x0` + `/mpc_debug` recording via
`read_from_bag_trajectory.py`). Records per-tick inputs/outputs into numpy
arrays, feeds `plots.plot_mpc_data`, and round-trips through `.npz` so runs
can be replayed offline.

Port of the JAX package's `runtime/recorder.py` (numpy over `mpc/data.py`):
the same npz keys and bag topics, so a recording from either package reads
in the other."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from ..mpc.data import MPCDebugData, OCPResults


class MPCRecorder:
    def __init__(self):
        self.time_ns: List[int] = []
        self.x0: List[np.ndarray] = []
        self.state_predictions: List[np.ndarray] = []
        self.control_predictions: List[np.ndarray] = []
        self.kkt: List[float] = []
        self.iters: List[int] = []
        self.qp_iters: List[int] = []
        self.solve_time_ns: List[int] = []
        # named per-cost debug streams (reference `<name>_references` /
        # `<name>_residuals`, `read_from_bag_trajectory.py:102-188`)
        self.references: Dict[str, List[np.ndarray]] = {}
        self.residuals: Dict[str, List[np.ndarray]] = {}

    def record(self, time_ns: int, x0: np.ndarray, res: OCPResults,
               debug: MPCDebugData) -> None:
        self.time_ns.append(time_ns)
        self.x0.append(np.asarray(x0))
        self.state_predictions.append(res.states)
        self.control_predictions.append(res.feed_forward_terms)
        self.kkt.append(debug.ocp.kkt_norm if debug.ocp else 0.0)
        self.iters.append(debug.ocp.nb_iter if debug.ocp else 0)
        self.qp_iters.append(debug.ocp.nb_qp_iter if debug.ocp else 0)
        self.solve_time_ns.append(debug.duration_ocp_solve_ns)
        if debug.ocp is not None:
            for name, v in (debug.ocp.references or {}).items():
                self.references.setdefault(name, []).append(np.asarray(v))
            for name, v in (debug.ocp.residuals or {}).items():
                self.residuals.setdefault(name, []).append(np.asarray(v))

    def as_mpc_data(self) -> Dict[str, np.ndarray]:
        t0 = self.time_ns[0] if self.time_ns else 0
        return {
            "time": (np.asarray(self.time_ns) - t0) / 1e9,
            "x0": np.stack(self.x0) if self.x0 else np.zeros((0, 0)),
            "state_predictions": np.stack(self.state_predictions)
            if self.state_predictions else np.zeros((0, 0, 0)),
            "control_predictions": np.stack(self.control_predictions)
            if self.control_predictions else np.zeros((0, 0, 0)),
            "kkt": np.asarray(self.kkt),
            "iters": np.asarray(self.iters),
            "qp_iters": np.asarray(self.qp_iters),
            "solve_time_ns": np.asarray(self.solve_time_ns),
            **{f"{n}_references": np.stack(v)
               for n, v in self.references.items()},
            **{f"{n}_residuals": np.stack(v)
               for n, v in self.residuals.items()},
        }

    def save(self, path) -> None:
        np.savez_compressed(Path(path), **self.as_mpc_data())

    @staticmethod
    def load(path) -> Dict[str, np.ndarray]:
        with np.load(Path(path)) as f:
            return {k: f[k] for k in f.files}

    # ---- bag container formats (reference rosbag2 analog) ----------------

    def _topics(self):
        ts = self.time_ns
        scalar = lambda xs: [(t, np.asarray([v], float))
                             for t, v in zip(ts, xs)]
        return {
            "/ocp_x0": list(zip(ts, self.x0)),
            "/mpc_debug/state_predictions": list(
                zip(ts, self.state_predictions)),
            "/mpc_debug/control_predictions": list(
                zip(ts, self.control_predictions)),
            "/mpc_debug/kkt": scalar(self.kkt),
            "/mpc_debug/iters": scalar(self.iters),
            "/mpc_debug/qp_iters": scalar(self.qp_iters),
            "/ocp_solve_time": scalar(self.solve_time_ns),
            **{f"/mpc_debug/{n}_references": list(zip(ts, v))
               for n, v in self.references.items()},
            **{f"/mpc_debug/{n}_residuals": list(zip(ts, v))
               for n, v in self.residuals.items()},
        }

    def save_bag(self, path, fmt: str = "mcap") -> None:
        """Write an mcap or rosbag2-layout sqlite3 bag (the reference
        records the same streams with rosbag2,
        `read_from_bag_trajectory.py:57-196`)."""
        from .bag_readers import write_mcap_bag, write_sqlite_bag

        if fmt == "mcap":
            write_mcap_bag(path, self._topics())
        elif fmt in ("sqlite3", "db3"):
            write_sqlite_bag(path, self._topics())
        else:
            raise ValueError(f"unknown bag format {fmt!r}")

    @staticmethod
    def load_bag(path) -> Dict[str, np.ndarray]:
        """Container-autodetecting load back into the npz-schema dict."""
        from .bag_readers import load_bag, load_mpc_outputs_from_bag

        bag = load_bag(path)
        out = load_mpc_outputs_from_bag(path)
        x0_recs = bag.get("/ocp_x0", [])
        t = np.asarray([ts for ts, _ in x0_recs], dtype=np.int64)
        t0 = t[0] if len(t) else 0
        out["time"] = (t - t0) / 1e9
        out["x0"] = (np.stack([a for _, a in x0_recs])
                     if x0_recs else np.zeros((0, 0)))
        out["solve_time_ns"] = out["solve_time_ns"].astype(np.int64)
        out["iters"] = out["iters"].astype(np.int64)
        out["qp_iters"] = out["qp_iters"].astype(np.int64)
        return out
