"""The reference's own solve: FDDP (Crocoddyl's `SolverFDDP`) over rows,
in plain PyTorch, from the same start and warm start the program was given.

Each row is an independent problem: its state x0 [nx], warm start
xs [T+1, nx], us [T, nu]. One iteration linearises at the iterate (the
step's Jacobians, the costs' Gauss-Newton derivatives), runs a Riccati
pass at the row's Levenberg-Marquardt regularisation and tries the step
lengths alpha = 0.5**i in order, each a gap-contracting rollout, taking
the first that the feasibility-gated filter accepts: a cost decrease, or,
while the row's largest defect is above the gate, a contraction of the
defects. The regularisation falls by `reg_dec` after an accepted step and
rises by `reg_inc` otherwise. A row stops once its KKT residual
max(max |Qu|, largest defect) is under the termination tolerance. After
the last iteration a report pass at `reg_min` gives the gains and the KKT
residual of the returned iterate.

The settings are the traffic mix's "solver" entry, the same numbers the
program's solver is built from.
"""

from __future__ import annotations

import torch

from .check import linearise, total_cost
from .model import Robot
from .ocp import Costs, riccati

DEFAULTS = dict(max_iters=10, n_alphas=10, termination_tolerance=1e-3,
                reg_init=1e-9, reg_min=1e-9, reg_max=1e9, reg_inc=10.0,
                reg_dec=10.0)


def gate(dtype) -> float:
    """Largest defect under which a row counts as feasible: 1e-9, or 100
    machine epsilons of `dtype` where that is larger (a feasible float32
    trajectory keeps defects of a few epsilons)."""
    return max(1e-9, 100.0 * torch.finfo(dtype).eps)


def rollout(robot: Robot, costs: Costs, alpha, x0, xs, us, k, K, fs, dts):
    """(xs, us, cost) of the rollout at step length `alpha`:
    u_t = us_t - alpha k_t - K_t (x_t - xs_t), with the defects closed by
    a share alpha."""
    a1 = 1.0 - alpha
    x = x0 - a1 * fs[:, 0]
    xs_new, us_new = [x], []
    for t in range(xs.shape[1] - 1):
        u = us[:, t] - alpha * k[:, t] - robot.mv(K[:, t], x - xs[:, t])
        x = robot.step(x, u, dts[t].expand(x.shape[0])) - a1 * fs[:, t + 1]
        xs_new.append(x)
        us_new.append(u)
    xs_t, us_t = torch.stack(xs_new, 1), torch.stack(us_new, 1)
    return xs_t, us_t, total_cost(robot, costs, xs_t, us_t, dts)


def solve(robot: Robot, costs: Costs, x0, xs, us, dts, settings=None):
    """FDDP from x0 [R, nx] and the warm start xs [R, T+1, nx],
    us [R, T, nu], per-step dt `dts` [T]: {"xs", "us", "K", "cost", "kkt",
    "gap", "iters", "converged"}, each with a leading [R]."""
    s = dict(DEFAULTS, **(settings or {}))
    if not s.get("use_filter_line_search", True):
        raise ValueError("the reference solves with the filter line search")
    t = lambda a: a.to(device=robot.device, dtype=robot.dtype)
    x0, xs, us, dts = t(x0), t(xs), t(us), t(dts)
    R = x0.shape[0]
    kw = dict(dtype=robot.dtype, device=robot.device)
    cost = total_cost(robot, costs, xs, us, dts)
    reg = torch.full((R,), s["reg_init"], **kw)
    converged = torch.zeros(R, dtype=torch.bool, device=robot.device)
    iters = torch.zeros(R, dtype=torch.long, device=robot.device)
    feasible = gate(robot.dtype)
    for _ in range(int(s["max_iters"])):
        if bool(converged.all()):
            break
        lin = linearise(robot, costs, x0, xs, us, dts)
        fs, gap = lin["fs"], lin["gap"]
        K, k, Qu = riccati(robot, *lin["derivs"], fs, *lin["terminal"], reg)
        bad = ~(torch.isfinite(K).flatten(1).all(1)
                & torch.isfinite(k).flatten(1).all(1))
        kkt = torch.maximum(Qu.abs().amax((1, 2)), gap)
        done = converged | bad
        took = torch.zeros_like(done)
        xs_b, us_b, cost_b = xs, us, cost
        for i in range(int(s["n_alphas"])):
            if bool(done.all()):
                break
            alpha = 0.5 ** i
            xs_t, us_t, cost_t = rollout(robot, costs, alpha, x0, xs, us, k,
                                         K, fs, dts)
            finite = (torch.isfinite(xs_t).flatten(1).all(1)
                      & torch.isfinite(cost_t))
            contracts = (gap > feasible) & ((1.0 - alpha) * gap
                                            < gap * (1.0 - 1e-6))
            take = finite & ((cost - cost_t > 0.0) | contracts) & ~done
            xs_b = torch.where(take[:, None, None], xs_t, xs_b)
            us_b = torch.where(take[:, None, None], us_t, us_b)
            cost_b = torch.where(take, cost_t, cost_b)
            done, took = done | take, took | take
        live = ~converged
        ok = took & live
        xs = torch.where(ok[:, None, None], xs_b, xs)
        us = torch.where(ok[:, None, None], us_b, us)
        cost = torch.where(ok, cost_b, cost)
        step = torch.where(took & ~bad, reg / s["reg_dec"], reg * s["reg_inc"])
        reg = torch.where(converged, reg,
                          step.clamp(s["reg_min"], s["reg_max"]))
        iters = iters + live.long()
        converged = converged | (kkt < s["termination_tolerance"])
    lin = linearise(robot, costs, x0, xs, us, dts)
    K, _, Qu = riccati(robot, *lin["derivs"], lin["fs"], *lin["terminal"],
                       torch.full((R,), s["reg_min"], **kw))
    kkt = torch.maximum(Qu.abs().amax((1, 2)), lin["gap"])
    return {"xs": xs, "us": us, "K": K, "cost": cost, "kkt": kkt,
            "gap": lin["gap"], "iters": iters,
            "converged": converged | (kkt < s["termination_tolerance"])}

