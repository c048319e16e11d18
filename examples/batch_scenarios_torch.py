"""Batched scenario sweep on the PyTorch port (the port's copy of
`examples/batch_scenarios.py`; BASELINE.json config 5: "4096 perturbed-
dynamics MPC scenarios").

Perturbs initial states across the batch and solves all OCPs in one call
of the batch-native FDDP (`make_batch_fddp`: the step kernels K5a/K5b
over every node of the batch).

Usage:  python examples/batch_scenarios_torch.py [--batch 512]
            [--horizon 50] [--iters 10] [--device cuda|cpu]
"""

import argparse
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--horizon", type=int, default=50)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)

    import torch

    from agimus_controller_tpu_torch.models.panda import (
        PANDA_Q_READY,
        load_panda,
    )
    from agimus_controller_tpu_torch.ocp.spec import (
        CostItem,
        ProblemSpec,
        default_references,
    )
    from agimus_controller_tpu_torch.ops import kinematics
    from agimus_controller_tpu_torch.solver.fddp import SolverSettings
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

    device = torch.device(args.device)
    model, params = load_panda(device=device)
    T = args.horizon
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="ctrl_reg", kind="control_grav", weight=1e-3),
            CostItem(name="goal", kind="frame_placement", weight=10.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        terminal_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="goal", kind="frame_placement", weight=100.0,
                     update=True, frame="panda_hand_tcp"),
        ),
        horizon=T, dt=0.01,
    )
    refs = default_references(spec, model, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    q0 = torch.as_tensor(PANDA_Q_READY, **f32)
    x0 = torch.cat([q0, torch.zeros(7, **f32)])
    fid = model.frame_id("panda_hand_tcp")
    R0, p0 = kinematics.frame_placement(model, params, q0, fid)
    refs["xref"] = x0[None].repeat(T + 1, 1)
    refs["ee_rot:panda_hand_tcp"] = R0[None].repeat(T + 1, 1, 1)
    refs["ee_trans:panda_hand_tcp"] = (
        p0 + torch.as_tensor([0.1, 0.05, -0.05], **f32))[None].repeat(T + 1, 1)

    B = args.batch
    rng = np.random.default_rng(0)
    x0s = x0[None] + torch.as_tensor(0.05 * np.concatenate(
        [rng.normal(size=(B, 7)), rng.normal(size=(B, 7))], axis=1), **f32)
    xs0 = x0s[:, None, :].repeat(1, T + 1, 1)
    us0 = torch.zeros((B, T, 7), **f32)

    solve = make_batch_fddp(model, params, spec,
                            SolverSettings(max_iters=args.iters),
                            device=device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"warming up batch={B} T={T} on {name}...")
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    sol = solve(x0s, refs, xs0, us0)
    sync()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        sol = solve(x0s, refs, xs0, us0)
        sync()
        times.append(time.perf_counter() - t0)
    t = float(np.median(times))
    conv = float(sol.converged.float().mean())
    print(f"{B} scenario solves in {t*1e3:.1f} ms -> {B/t:.0f} solves/s | "
          f"{100*conv:.0f}% converged | mean iters "
          f"{float(sol.iters.float().mean()):.1f}")


if __name__ == "__main__":
    main()
