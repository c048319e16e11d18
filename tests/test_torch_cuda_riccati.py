"""The Riccati sweep kernel `ag_riccati` on the card, f32.

Marked `cuda`: skips without a CUDA device (a CUDA kernel has no CPU mode;
its per-thread program is held on the CPU by `test_torch_riccati_kernel.py`
through the g++ harness).

- `RiccatiKernel` against `backward_components` in float32 and the same
  sweep in float64, at nj = 7, 8 and 17, B in {1, 37, 4096} and T in
  {1, 20, 100}, on seeded LQ data drawn on the card
  (`chip_smoke.random_lq`: reg per scenario, scenario 1 with a NaN input,
  scenario 2 with an indefinite Quu), by `chip_smoke.riccati_check`: the
  kernel flags the same scenarios `bad` and leaves the same entries
  non-finite, and its error against float64 (largest over the output, as a
  share of the float64 output's largest magnitude) stays within twice the
  plain float32 sweep's plus `RICCATI_FLOOR`; at T = 100 this also holds
  the float32 drift of the component sweep no worse in the kernel.
- The float32 drift of the component sweep at T = 100 (ROADMAP queue 3,
  item 1), which the seeded LQ data does not show: on the Panda batch
  problem of `chip_smoke.py` phase 4 at B = 64, linearised at the warm start
  and at the first variant's solution, the kernel's gains Ks (the drift's
  measure, `K_rel`) stay within twice the plain float32 sweep's error plus
  `RICCATI_FLOOR`.
- The same on the benchmark cell's own problem (`tiago-full-t20-batch4096`:
  the full 17-DoF Tiago-Pro, T = 20) linearised by `BatchFDDP.derivs_of`
  at its warm start, B = 64.
- A whole `BatchFDDP` solve of that problem at B = 64 with the kernel and
  with the plain sweep: equal iterations and convergence flags, xs within
  `XS_TOL`; the kernel's solve never reaches the plain sweep and launches
  once a sweep.

On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_riccati.py
"""

import sys
from pathlib import Path

import pytest
import torch

from chip_smoke import random_lq, riccati_check

pytestmark = pytest.mark.cuda

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
CELL = "tiago-full-t20-batch4096"
# xs of the two solves: the bound `chip_smoke.PSCAN_XS_TOL` holds the
# horizon-parallel sweep's solve to, for the same reason (float32 rounding
# of another sweep, carried through the line search)
XS_TOL = 1e-3


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Riccati kernel runs only on "
                    "the GPU")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("T", [1, 20, 100])
@pytest.mark.parametrize("B", [1, 37, 4096])
@pytest.mark.parametrize("nj", [7, 8, 17])
def test_kernel_matches_plain(device, nj, B, T):
    from agimus_controller_tpu_torch.ops.cuda_riccati import RiccatiKernel
    from agimus_controller_tpu_torch.solver.riccati_components import (
        backward_components,
    )

    a64 = random_lq(T, B, nj, seed=1000 * nj + 10 * B + T, device=device)
    a32 = [a.float() for a in a64]
    k = RiccatiKernel(nj, device)
    got = k(*a32)
    torch.cuda.synchronize()
    assert k.launches == 1
    assert [g.dtype for g in got] == [torch.float32] * 5 + [torch.bool]
    want = backward_components(*a64)
    plain = backward_components(*a32)
    riccati_check(f"nj={nj} B={B} T={T}", got, plain, want)
    assert got[5].tolist() == ([False, True, True] + [False] * (B - 3))[:B]


def test_drift_at_t100(device, monkeypatch):
    import chip_smoke as smoke

    from agimus_controller_tpu_torch.solver.riccati_components import (
        backward_components,
    )

    monkeypatch.setattr(smoke, "BATCH_B", 64)
    bp = smoke.build_batch(device, 1)
    s, x0s = bp.solver, bp.variants[0]
    sol = smoke.solve_rows(bp, x0s)
    reg = torch.full((64,), 1e-9, device=device)
    for xs, us in ((bp.xs0, bp.us0), (sol.xs, sol.us)):
        xs = xs.transpose(0, 1).contiguous()
        us = us.transpose(0, 1).contiguous()
        dyn, costs, term = s.derivs_of(xs, us, bp.refs)
        fs = s._gaps_of(x0s, xs, dyn[0])
        a32 = [dyn[1], dyn[2], *costs[1:], fs, term[1], term[2], reg]
        riccati_check("Panda T=100", s.riccati_k(*a32),
                      backward_components(*a32),
                      backward_components(*(a.double() for a in a32)),
                      ("Ks",))


@pytest.fixture(scope="module")
def cell(device):
    """The cell's problem on the card, its solver settings, and B = 64
    seeded starts (ready + N(0, start_noise^2) on q)."""
    for p in (str(BENCH), str(BENCH.parent)):
        if p not in sys.path:
            sys.path.insert(0 if p == str(BENCH) else 1, p)
    import harness

    from agimus_controller_tpu_torch.solver.fddp import SolverSettings

    c = harness.load_cell(CELL)
    p = harness.build_problem(c, device)
    B, T, nj = 64, p.spec.horizon, p.model.nj
    g = torch.Generator(device=device)
    g.manual_seed(17)
    xr = torch.as_tensor(p.x_ready, dtype=torch.float32, device=device)
    x0 = xr.expand(B, -1).clone()
    x0[:, :nj] += c.mix["start_noise"] * torch.randn(
        (B, nj), generator=g, device=device)
    return dict(p=p, settings=SolverSettings(**c.mix["solver"]), x0=x0,
                xs=xr.expand(B, T + 1, -1).contiguous(),
                us=torch.zeros((B, T, nj), device=device))


def _solver(cell, device):
    from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

    p = cell["p"]
    return make_batch_fddp(p.model, p.params, p.spec, cell["settings"],
                           device=device)


def test_kernel_on_the_cell_linearisation(device, cell):
    from agimus_controller_tpu_torch.solver.riccati_components import (
        backward_components,
    )

    s = _solver(cell, device)
    xs = cell["xs"].transpose(0, 1).contiguous()
    us = cell["us"].transpose(0, 1).contiguous()
    dyn, costs, term = s.derivs_of(xs, us, cell["p"].refs)
    fs = s._gaps_of(cell["x0"], xs, dyn[0])
    reg = torch.full((xs.shape[1],), cell["settings"].reg_min, device=device)
    a32 = [dyn[1], dyn[2], *costs[1:], fs, term[1], term[2], reg]
    got = s.riccati_k(*a32)
    torch.cuda.synchronize()
    assert s.riccati_k.launches == 1 and not bool(got[5].any())
    riccati_check(CELL, got, backward_components(*a32),
                  backward_components(*(a.double() for a in a32)))


def test_solve_with_the_kernel(device, cell, monkeypatch):
    from agimus_controller_tpu_torch.solver import fddp_batch
    from agimus_controller_tpu_torch.solver.riccati_components import (
        backward_components,
    )

    plain = _solver(cell, device)
    plain.riccati_k = backward_components
    want = plain(cell["x0"], cell["p"].refs, cell["xs"], cell["us"])
    torch.cuda.synchronize()

    s = _solver(cell, device)
    monkeypatch.setattr(fddp_batch, "backward_components",
                        lambda *a: pytest.fail("the plain sweep was called"))
    got = s(cell["x0"], cell["p"].refs, cell["xs"], cell["us"])
    torch.cuda.synchronize()
    assert s.riccati_k.launches == int(got.iters.max()) + 1
    assert torch.equal(got.iters, want.iters)
    assert torch.equal(got.converged, want.converged)
    assert bool(torch.isfinite(got.xs).all())
    dx = float((got.xs - want.xs).abs().max())
    assert dx < XS_TOL, dx
