"""Offline plot CLI on the PyTorch port (the port's copy of
`examples/plot_run.py`; reference `agimus_controller_ros/mpc_plot_node.py`):
load a recorded run (`MPCRecorder` npz — the rosbag analog) and emit the
standard diagnostic plots + prediction-tail figures as JSON sidecars (and
PNGs when matplotlib is available).

Usage:  python examples/plot_run_torch.py RUN.npz [--out DIR]
            [--ee panda_hand_tcp] [--dt 0.01] [--device cuda|cpu]
"""

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run", type=str)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--ee", type=str, default="panda_hand_tcp")
    ap.add_argument("--dt", type=float, default=0.01)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.plots.mpc_utils import plot_tails
    from agimus_controller_tpu_torch.plots.plots_utils import plot_mpc_data
    from agimus_controller_tpu_torch.runtime.recorder import MPCRecorder

    out = Path(args.out or (Path(args.run).stem + "_plots"))
    out.mkdir(parents=True, exist_ok=True)
    data = MPCRecorder.load(args.run)
    plot_mpc_data(data, which_plots=["computation_time", "iter"],
                  dump_path=str(out), show=True)
    model, params = load_panda(device=args.device)
    plot_tails(data["state_predictions"], data["control_predictions"],
               dt=args.dt, model=model, params=params, ee_frame=args.ee,
               dump_path=str(out), show=True)
    print(f"plots + JSON sidecars written to {out}")


if __name__ == "__main__":
    main()
