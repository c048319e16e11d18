"""The batch FDDP's spans (`agimus_controller_tpu_torch/spans.py`): none is
built without a profiler; under one, a solve of the Panda (T = 3, B = 4,
the plain step versions on the CPU) records one "fddp.solve" holding every
other span, one "fddp.sync" per host sync, one "fddp.riccati" per backward
pass and "fddp.costs" never inside a Riccati span; and the profiler changes
no output bit."""

import numpy as np
import pytest
import torch

from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu_torch.ocp.spec import (
    CostItem,
    ProblemSpec,
    default_references,
)
from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp

CPU = dict(device="cpu")
T, B = 3, 4
NAMES = {"fddp.solve", "fddp.riccati", "fddp.costs", "fddp.sync"}


def _problem():
    model, params = load_panda(dtype=torch.float64, **CPU)
    spec = ProblemSpec(
        running_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="control_reg", kind="control_grav", weight=1e-3),
            CostItem(name="goal_tracking", kind="frame_placement",
                     weight=10.0, update=True, frame="panda_hand_tcp")),
        terminal_costs=(
            CostItem(name="state_reg", kind="state", weight=0.1, update=True),
            CostItem(name="goal_tracking", kind="frame_placement",
                     weight=100.0, update=True, frame="panda_hand_tcp")),
        horizon=T, dt=0.01)
    x_ready = torch.as_tensor(np.concatenate([PANDA_Q_READY, np.zeros(7)]),
                              dtype=torch.float64)
    refs = default_references(spec, model, dtype=torch.float64, **CPU)
    refs["xref"] = x_ready.expand(T + 1, -1).clone()
    refs["ee_trans:panda_hand_tcp"] = torch.tensor(
        [[0.4, 0.1, 0.5]], dtype=torch.float64).expand(T + 1, -1).clone()
    gen = torch.Generator().manual_seed(3)
    dq = 0.05 * torch.randn((B, 7), generator=gen, dtype=torch.float64)
    x0s = x_ready + torch.cat([dq, torch.zeros_like(dq)], 1)
    solver = make_batch_fddp(model, params, spec, SolverSettings(max_iters=2),
                             **CPU)
    args = (x0s, refs, x_ready.expand(B, T + 1, -1).contiguous(),
            torch.zeros((B, T, 7), dtype=torch.float64))
    return solver, args


@pytest.fixture(scope="module")
def plain():
    """A solve with no profiler, building a `record_function` refused:
    (the host syncs it made, the solution)."""
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built")

    solver, args = _problem()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        sol = solver(*args)
    return solver.host_syncs, sol


@pytest.fixture(scope="module")
def traced():
    """A solve under the profiler: (its spans [(start, end, name)] in time
    order, the backward passes and host syncs it made, the solution)."""
    solver, args = _problem()
    backward, passes = solver.backward, []
    solver.backward = lambda *a: (passes.append(1), backward(*a))[1]
    syncs = solver.host_syncs
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        sol = solver(*args)
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.is_user_annotation() and e.name() in NAMES)
    return spans, len(passes), solver.host_syncs - syncs, sol


def _count(spans, name):
    return sum(n == name for _, _, n in spans)


def test_no_record_function_without_a_profiler(plain):
    syncs, sol = plain
    assert syncs > 0 and int(sol.iters.max()) > 0


def test_one_solve_span_holds_every_other(traced):
    spans = traced[0]
    assert _count(spans, "fddp.solve") == 1
    (a, b, _), = [s for s in spans if s[2] == "fddp.solve"]
    assert {n for _, _, n in spans} == NAMES
    assert all(a <= s0 and s1 <= b for s0, s1, _ in spans)


def test_sync_spans_equal_host_syncs(traced):
    spans, _, syncs, _ = traced
    assert syncs > 0 and _count(spans, "fddp.sync") == syncs


def test_riccati_spans_equal_backward_passes(traced):
    spans, passes, _, _ = traced
    assert passes >= 2 and _count(spans, "fddp.riccati") == passes


def test_cost_spans_never_inside_riccati(traced):
    spans = traced[0]
    riccati = [(a, b) for a, b, n in spans if n == "fddp.riccati"]
    costs = [(a, b) for a, b, n in spans if n == "fddp.costs"]
    assert costs
    assert not any(ra <= ca < rb for ca, _ in costs for ra, rb in riccati)


def test_profiler_changes_no_output(plain, traced):
    for name in ("xs", "us", "K", "cost", "iters"):
        assert torch.equal(getattr(plain[1], name),
                           getattr(traced[3], name)), name
