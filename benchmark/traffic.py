"""The one traffic generator: it reads a traffic mix (`traffic/<name>.json`)
and drives the program's solver over the seeded inputs in a closed loop.

The mix's "loop" names the loop; there is one, "batch": back-to-back batch
FDDP solves of B scenarios, each from fresh seeded starts (ready +
N(0, start_noise^2) on q), the warm start xs tiled from the ready state and
us zero. The solver is built from the mix's "solver" settings, which the
reference's own solve reads too. Set-up solves one such batch, so that the
caching allocator holds what every solve needs. A unit is one solve.

Every unit keeps `check_rows` rows drawn from the seed (their inputs and
the solver's outputs) for the check after the window, counts rows with a
non-finite output, and sums the rows' iterations on the device.
"""

from __future__ import annotations

import numpy as np
import torch

SAMPLED = ("x0", "xs", "us", "K", "cost", "kkt", "gap", "iters", "converged")


def _seed(seed: int) -> int:
    return int(seed) % (2 ** 63)


class BatchLoop:
    """Back-to-back batch FDDP solves. `problem` is the harness's
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


LOOPS = {"batch": BatchLoop}


def make_loop(problem, mix: dict, seed: int, device) -> BatchLoop:
    return LOOPS[mix["loop"]](problem, mix, seed, device)
