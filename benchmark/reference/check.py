"""What decides `correct`: the quantities a solve publishes, worked out
again by the reference, and the reference's own solve of the same rows.

For each checked row (one scenario of one solve) the solver publishes
x0, xs, us, the feedback gains K, its cost, its largest dynamics defect
(gap), its KKT residual, its iteration count and its converged flag.

At the row's own (x0, xs, us) the reference computes (`evaluate`):

- gap: max |x0 - xs[0]|, |step(xs[t], us[t]) - xs[t+1]|   (the step)
- cost: sum_t dt l(xs[t], us[t]) + l_T(xs[T])               (the costs)
- K, kkt: the dynamics' Jacobians, the costs' Gauss-Newton derivatives and
  a Riccati pass at regularisation `reg`; kkt = max(max |Qu|, gap).

From the row's x0 and the warm start the program was given, the reference
also solves the row itself (`fddp.solve`), so the iterate is held to
being the solution and not only to agreeing with itself.

`compare` turns these into the numbers held against the limits: the
largest relative cost error, the largest absolute gap difference, the
largest relative gain error (per row, over the row's largest gain) and the
largest absolute KKT difference at the returned iterate; the largest
absolute distance of the returned xs from the reference's solution, the
largest relative distance of the returned cost from the solution's; and
the share of rows whose iteration count or converged flag differs from the
reference solve's.
"""

from __future__ import annotations

import torch

from .model import Robot
from .ocp import Costs, riccati, step_derivs

BLOCK = 2048  # nodes per block of the derivative evaluations


def _blocks(n, size=BLOCK):
    return [slice(i, min(i + size, n)) for i in range(0, n, size)]


def total_cost(robot: Robot, costs: Costs, xs, us, dts):
    """[R]: sum_t dt l(xs[t], us[t]) + l_T(xs[T]) of rows xs [R, T+1, nx],
    us [R, T, nu]."""
    R, T1, nx = xs.shape
    T = T1 - 1
    xf = xs[:, :-1].reshape(R * T, nx)
    uf = us.reshape(R * T, -1)
    df = dts.repeat(R)
    run = torch.cat([costs.running_value(xf[b], uf[b], df[b])
                     for b in _blocks(R * T)])
    return run.reshape(R, T).sum(1) + costs.terminal_value(xs[:, -1])


def linearise(robot: Robot, costs: Costs, x0, xs, us, dts):
    """At rows x0 [R, nx], xs [R, T+1, nx], us [R, T, nu]: the defects
    `fs` [R, T+1, nx] and their largest `gap` [R], the node derivatives
    `derivs` (Fx, Fu, lx, lu, lxx, lxu, luu, each [R, T, ...]) and the
    terminal (lx, lxx)."""
    R, T1, nx = xs.shape
    T, nu = T1 - 1, us.shape[-1]
    xf = xs[:, :-1].reshape(R * T, nx)
    uf = us.reshape(R * T, nu)
    df = dts.repeat(R)
    parts = [step_derivs(robot, xf[b], uf[b], df[b])
             + costs.running_derivs(xf[b], uf[b], df[b])[1:]
             for b in _blocks(R * T)]
    xnext, Fx, Fu, lx, lu, lxx, lxu, luu = (
        torch.cat([p[i] for p in parts]).reshape((R, T) + parts[0][i].shape[1:])
        for i in range(8))
    fs = torch.cat([(x0 - xs[:, 0])[:, None], xnext - xs[:, 1:]], 1)
    _, tlx, tlxx = costs.terminal_derivs(xs[:, -1])
    return {"fs": fs, "gap": fs.abs().amax((1, 2)),
            "derivs": (Fx, Fu, lx, lu, lxx, lxu, luu), "terminal": (tlx, tlxx)}


def evaluate(robot: Robot, costs: Costs, x0, xs, us, dts, reg):
    """The reference's quantities at rows x0 [R, nx], xs [R, T+1, nx],
    us [R, T, nu] with per-step dt `dts` [T]: {"cost" [R], "gap" [R],
    "K" [R, T, nu, nx], "kkt" [R]}, the gains and KKT residual of a
    Riccati pass regularised by `reg` [R]."""
    t = lambda a: a.to(device=robot.device, dtype=robot.dtype)
    x0, xs, us, dts = t(x0), t(xs), t(us), t(dts)
    lin = linearise(robot, costs, x0, xs, us, dts)
    K, _, Qu = riccati(robot, *lin["derivs"], lin["fs"], *lin["terminal"],
                       t(reg))
    return {"cost": total_cost(robot, costs, xs, us, dts), "gap": lin["gap"],
            "K": K, "kkt": torch.maximum(Qu.abs().amax((1, 2)), lin["gap"])}


def compare(got, want, solved):
    """The numbers compared, from the solver's (or a control's) outputs
    `got`, the reference's quantities `want` at the same iterate (as
    `evaluate` gives them) and the reference's own solve `solved` from the
    same start and warm start (as `fddp.solve` gives it)."""
    f = lambda a: a.detach().double().cpu()
    cost_g, cost_w, cost_s = f(got["cost"]), f(want["cost"]), f(solved["cost"])
    Kg, Kw = f(got["K"]), f(want["K"])
    iters_g, iters_s = f(got["iters"]), f(solved["iters"])
    same = ((iters_g == iters_s)
            & (f(got["converged"]).bool() == f(solved["converged"]).bool()))
    return {
        "cost_rel": float(((cost_g - cost_w).abs() / cost_w.abs()).max()),
        "gap_abs": float((f(got["gap"]) - f(want["gap"])).abs().max()),
        "K_rel": float(((Kg - Kw).abs().amax((1, 2, 3))
                        / Kw.abs().amax((1, 2, 3))).max()),
        "kkt_abs": float((f(got["kkt"]) - f(want["kkt"])).abs().max()),
        "xs_abs": float((f(got["xs"]) - f(solved["xs"])).abs().max()),
        "cost_opt_rel": float(((cost_g - cost_s).abs() / cost_s.abs()).max()),
        "flags_pct": float(100.0 * (~same).double().mean()),
    }
