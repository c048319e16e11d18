"""The batch loop: back-to-back batch FDDP solves of B scenarios, each from
fresh seeded starts (ready + N(0, start_noise^2) on q), the warm start xs
tiled from the ready state and us zero. The solver is built from the mix's
"solver" settings, which the reference's own solve reads too. Set-up
solves one such batch, so that the caching allocator holds what every
solve needs. A unit is one solve.

Every unit keeps `check_rows` rows drawn from the seed (their inputs and
the solver's outputs) for the check after the window, counts rows with a
non-finite output, and sums the rows' iterations on the device.

The problem is the configuration's goal-tracking OCP (`build_problem`);
the check holds the sampled rows against the float64 reference's FDDP
(`check`, `NUMBERS`).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

SAMPLED = ("x0", "xs", "us", "K", "cost", "kkt", "gap", "iters", "converged")
NUMBERS = ("cost_rel", "gap_abs", "K_rel", "kkt_abs", "xs_abs",
           "cost_opt_rel", "flags_pct")


def _seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


def build_problem(cell, device, horizon=None):
    """The program's model, spec and refs for the cell's configuration,
    and the reference's ready state, gravity torque and goals (float64,
    from the benchmark's own kinematics), handed to the program."""
    from agimus_controller_tpu_torch.models.urdf import build_model_from_urdf
    from agimus_controller_tpu_torch.ocp.spec import (
        CostItem,
        ProblemSpec,
        default_references,
    )

    import reference

    cfg = cell.config
    offsets = dict(cfg["goal_offsets"])
    offsets.update(cell.mix.get("goal_offsets", {}))
    robot64, _, goals = reference.build(cfg, cell.urdf, offsets)
    nj = robot64.nj
    model, params = build_model_from_urdf(
        cell.urdf, armature=np.array(np.broadcast_to(cfg["armature"], (nj,)),
                                     dtype=float),
        dtype=torch.float32, device=device)
    if list(model.joint_names) != list(cfg["joints"]):
        raise ValueError(f"the program's joints {model.joint_names} are not "
                         f"the configuration's")
    item = lambda d: CostItem(name=d["name"], kind=d["kind"],
                              weight=d["weight"], update=d.get("update", False),
                              frame=d.get("frame"))
    T = cfg["horizon"] if horizon is None else horizon
    spec = ProblemSpec(
        running_costs=tuple(item(d) for d in cfg["running_costs"]),
        terminal_costs=tuple(item(d) for d in cfg["terminal_costs"]),
        horizon=T, dt=cfg["dt"])
    q = np.asarray(cfg["q_ready"], float)
    x_ready = np.concatenate([q, np.zeros(nj)])
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                  device=device)
    refs = default_references(spec, model, dtype=torch.float32, device=device)
    refs["xref"] = f(np.tile(x_ready[None], (T + 1, 1)))
    for frame, (R, p) in goals.items():
        if f"ee_rot:{frame}" in refs:
            refs[f"ee_rot:{frame}"] = f(np.tile(R[None], (T + 1, 1, 1)))
        refs[f"ee_trans:{frame}"] = f(np.tile(p[None], (T + 1, 1)))
    tau = robot64.gravity_torque(torch.as_tensor(q)).numpy()
    return SimpleNamespace(model=model, params=params, spec=spec, refs=refs,
                           x_ready=x_ready, tau_ready=tau, goals=goals,
                           offsets=offsets)


def check(cell, problem, loop, device, control=False):
    """The numbers compared for the loop's sampled rows: the program's
    outputs against the float64 reference, at the returned iterate and
    against the reference's own solve from the same start and warm start.
    With `control`, also (second) the same numbers of the control: the
    reference's solve in float32 with TF32 products, put in the program's
    place; else None."""
    import reference
    from reference.check import compare, evaluate
    from reference.fddp import solve

    rows = loop.rows()
    xs_w, us_w = loop.warm_start(rows["x0"].shape[0])
    settings = cell.mix["solver"]
    dts = torch.full((problem.spec.horizon,), cell.config["dt"],
                     dtype=torch.float64)
    robot, costs, _ = reference.build(cell.config, cell.urdf, problem.offsets,
                                      torch.float64, device)
    solved = solve(robot, costs, rows["x0"], xs_w, us_w, dts, settings)
    reg = torch.full(rows["cost"].shape, float(settings["reg_min"]),
                     dtype=torch.float64)

    def numbers(got):
        want = evaluate(robot, costs, rows["x0"], got["xs"], got["us"], dts,
                        reg)
        return compare(got, want, solved)

    prog = numbers(rows)
    if not control:
        return prog, None
    r32, c32, _ = reference.build(cell.config, cell.urdf, problem.offsets,
                                  torch.float32, device, tf32=True)
    return prog, numbers(solve(r32, c32, rows["x0"], xs_w, us_w, dts,
                               settings))


class Loop:
    """Back-to-back batch FDDP solves. `problem` is `build_problem`'s
    namespace of the program's model, spec and refs and the reference's
    ready state."""

    solver_name, unit_name = "fddp", "solve"

    def __init__(self, problem, mix: dict, seed: int, device):
        from agimus_controller_tpu_torch.solver.fddp import SolverSettings
        from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

        self.p, self.mix, self.device = problem, mix, torch.device(device)
        self.B = int(mix["batch"])
        self.T = problem.spec.horizon
        self.nj = problem.model.nj
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(_seed(seed))
        self.rng = np.random.default_rng(_seed(seed))
        self.x_ready = torch.as_tensor(problem.x_ready, dtype=torch.float32,
                                       device=self.device)
        self.units = 0
        self.samples = []
        self.bad_rows = torch.zeros((), dtype=torch.int64, device=self.device)
        self.iters_sum = torch.zeros((), dtype=torch.int64, device=self.device)
        self.record = True
        self.settings = SolverSettings(**mix["solver"])
        self.solver = make_batch_fddp(problem.model, problem.params,
                                      problem.spec, self.settings,
                                      device=self.device)
        B, T = self.B, self.T
        self.xs0 = self.x_ready.expand(B, T + 1, -1).contiguous()
        self.us0 = torch.zeros((B, T, self.nj), device=self.device)

    def sizes(self) -> dict:
        """The sizes the roofline's formulas name."""
        return dict(T=self.T, B=self.B, nj=self.nj)

    def noisy(self, base, sigma):
        """base [B, nx] with N(0, sigma^2) added to q."""
        dq = torch.randn((self.B, self.nj), generator=self.gen,
                         device=self.device) * sigma
        return base + torch.cat([dq, torch.zeros_like(dq)], 1)

    def keep(self, x0, sol):
        """Count the unit's rows and keep its sampled rows."""
        fin = (torch.isfinite(sol.xs).flatten(1).all(1)
               & torch.isfinite(sol.us).flatten(1).all(1)
               & torch.isfinite(sol.K).flatten(1).all(1))
        self.bad_rows += (~fin).sum()
        self.iters_sum += sol.iters.sum()
        self.units += 1
        if not self.record:
            return
        n = min(int(self.mix["check_rows"]), self.B)
        idx = torch.as_tensor(self.rng.choice(self.B, n, replace=False),
                              device=self.device)
        out = dict(x0=x0, xs=sol.xs, us=sol.us, K=sol.K, cost=sol.cost,
                   kkt=sol.kkt, gap=sol.gap_norm, iters=sol.iters,
                   converged=sol.converged)
        self.samples.append({k: v.index_select(0, idx) for k, v in out.items()})

    def counters(self) -> dict:
        """The program's counters and the loop's counts so far."""
        return {f"{self.solver_name}.host_syncs": self.solver.host_syncs,
                f"{self.solver_name}.iters": int(self.iters_sum),
                "rows": self.units * self.B, "units": self.units}

    def rows(self) -> dict:
        """The sampled rows of every recorded unit, stacked."""
        return {k: torch.cat([s[k] for s in self.samples]) for k in SAMPLED}

    def warm_start(self, n: int):
        """The warm start (xs [n, T+1, nx], us [n, T, nu]) that each of `n`
        rows was given."""
        return (self.xs0[:1].expand(n, -1, -1).contiguous(),
                self.us0[:1].expand(n, -1, -1).contiguous())

    def release(self):
        """Drop the solver (the sampled rows stay)."""
        self.solver = None

    def setup(self):
        self.record = False
        self.unit()
        self.record = True
        self.units = 0
        self.bad_rows.zero_()
        self.iters_sum.zero_()

    def unit(self):
        x0 = self.noisy(self.x_ready.expand(self.B, -1),
                        self.mix["start_noise"])
        self.keep(x0, self.solver(x0, self.p.refs, self.xs0, self.us0))
