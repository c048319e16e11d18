"""Weight-sweep OCP debugger on the PyTorch port (the port's copy of
`examples/debug_ocp.py`; reference `agimus_controller_examples/scripts/
debug_ocp.py:34-44`): load a recorded run, take one tick's initial state,
and sweep ONE cost weight across a range of values, re-solving the OCP
with the batch SQP (`make_batch_sqp`) at each — the cost/solution
sensitivity view used to tune weights offline.

Usage:
    python examples/debug_ocp_torch.py RUN.npz --cost goal_tracking \
        --values 1,3,10,30,100 [--tick 0] [--T 50] [--out DIR] \
        [--device cuda|cpu]

RUN.npz is an `MPCRecorder` file (or an mcap/sqlite bag recorded by
`MPCRecorder.save_bag`).
"""

import argparse
import json
from pathlib import Path

import numpy as np


def flagship_problem(model, T, device):
    """The flagship goal-tracking OCP (the runtime bench's): (spec, refs)
    with the state reference at the ready pose."""
    import torch

    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY
    from agimus_controller_tpu_torch.ocp.spec import (
        CostItem,
        ProblemSpec,
        default_references,
    )

    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="control_reg", kind="control_grav", weight=1e-3),
            CostItem(name="goal_tracking", kind="frame_placement", weight=10.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="goal_tracking", kind="frame_placement",
                     weight=100.0, update=True, frame="panda_hand_tcp"),
        ),
        horizon=T, dt=0.01)
    refs = default_references(spec, model, device=device)
    x0 = torch.cat([torch.as_tensor(PANDA_Q_READY, dtype=torch.float32),
                    torch.zeros(7)]).to(device)
    refs["xref"] = x0[None].repeat(T + 1, 1)
    return spec, refs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("run", type=str)
    ap.add_argument("--cost", type=str, default="goal_tracking",
                    help="cost name whose weight is swept")
    ap.add_argument("--values", type=str, default="0.1,1,10,100")
    ap.add_argument("--tick", type=int, default=0)
    ap.add_argument("--T", type=int, default=50)
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.ops import kinematics
    from agimus_controller_tpu_torch.plots.plots_utils import plot_values
    from agimus_controller_tpu_torch.runtime.recorder import MPCRecorder
    from agimus_controller_tpu_torch.solver.csqp import CSQPSettings
    from agimus_controller_tpu_torch.solver.sqp_batch import make_batch_sqp

    values = np.asarray([float(v) for v in args.values.split(",")])
    B = len(values)
    path = Path(args.run)
    data = (MPCRecorder.load(path) if path.suffix == ".npz"
            else MPCRecorder.load_bag(path))
    device = torch.device(args.device)
    f32 = dict(dtype=torch.float32, device=device)
    x0 = torch.as_tensor(np.asarray(data["x0"][args.tick]), **f32)

    model, params = load_panda(device=device)
    T = args.T
    spec, refs = flagship_problem(model, T, device)
    names = sorted({c.name for c in spec.all_costs()})
    if args.cost not in names:
        raise SystemExit(f"unknown cost {args.cost!r}; available: {names}")

    # the swept weight is a runtime weight array of the refs (weights are
    # refs inputs, never baked constants): one solve per value
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = kinematics.frame_placement(model, params, x0[:7], fid)
    refs["ee_rot:panda_hand_tcp"] = R0[None].repeat(T + 1, 1, 1)
    refs["ee_trans:panda_hand_tcp"] = (
        p0 + torch.as_tensor([0.05, 0.0, 0.05], **f32))[None].repeat(T + 1, 1)
    key_of = {"state_reg": "w_x", "control_reg": "w_u",
              "goal_tracking": "w_ee:panda_hand_tcp"}
    key = key_of.get(args.cost)
    base = refs[key]

    solver = make_batch_sqp(
        model, params, spec,
        CSQPSettings(max_iters=50, termination_tolerance=1e-6,
                     reg_init=1e-7), device=device)
    x0s = x0[None]
    xs0 = x0[None, None].repeat(1, T + 1, 1)
    us0 = torch.zeros((1, T, 7), **f32)
    sols = []
    for v in values:
        rb = dict(refs)
        rb[key] = float(v) * base
        sols.append(solver(x0s, rb, xs0, us0))
    cost = np.asarray([float(s.cost[0]) for s in sols])
    kkt = np.asarray([float(s.kkt[0]) for s in sols])
    ee_err = []
    du_vs_first = []
    us_ref = sols[0].us[0]
    goal = refs["ee_trans:panda_hand_tcp"][0]
    for s in sols:
        _, pT = kinematics.frame_placement(model, params, s.xs[0, -1, :7], fid)
        ee_err.append(float((pT - goal).norm()))
        du_vs_first.append(float((s.us[0] - us_ref).abs().max()))

    out = Path(args.out or (path.stem + "_weight_sweep"))
    out.mkdir(parents=True, exist_ok=True)
    series = np.stack([cost, np.asarray(ee_err)], axis=1)
    plot_values(f"weight sweep {args.cost}", series, values,
                labels=["total cost", "terminal EE error [m]"],
                dump_path=str(out))
    summary = {
        "cost_name": args.cost,
        "values": values.tolist(),
        "total_cost": cost.tolist(),
        "kkt": kkt.tolist(),
        "terminal_ee_error_m": ee_err,
        "max_du_vs_first": du_vs_first,
    }
    (out / "sweep_summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    print(f"sweep plots + JSON written to {out}")


if __name__ == "__main__":
    main()
