"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped, the rest of a run is driven on the
CPU at a small size, once for each fault a cell can have, and for a solve
cut short or a line search that never accepts. (One chip: no exchange
between chips to leave out.)"""

import dataclasses

import pytest
import torch

from _small_cells import SMALL, run_small


def _step_unchanged(monkeypatch):
    """The dynamics step returns its state unchanged (x+ = x, Fx = I,
    Fu = 0) where the step kernels produce it."""
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    def frozen(x, out):
        if not isinstance(out, tuple):
            return x.clone()
        n = x.shape[-1]
        return (x.clone(), torch.eye(n, dtype=x.dtype).expand_as(out[1]).clone(),
                torch.zeros_like(out[2]))

    step = StepKernel.__call__
    monkeypatch.setattr(StepKernel, "__call__",
                        lambda self, x, *a: frozen(x, step(self, x, *a)))


def _half_batch(monkeypatch):
    """The solver solves the first half of the batch and gives every row of
    the other half the mean over the first half."""
    from agimus_controller_tpu_torch.solver.fddp_batch import BatchFDDP

    call = BatchFDDP.__call__

    def run(self, x0s, refs, xs, us):
        h = x0s.shape[0] // 2
        sol = call(self, x0s[:h], refs, xs[:h], us[:h])

        def fill(v):
            if not isinstance(v, torch.Tensor):
                return v
            m = (v.double().mean(0, keepdim=True).to(v.dtype)
                 if v.is_floating_point() else v[:1])
            return torch.cat([v, m.expand((x0s.shape[0] - h,) + v.shape[1:])])
        return type(sol)(*(fill(v) for v in sol))

    monkeypatch.setattr(BatchFDDP, "__call__", run)


def _answer_altered(monkeypatch):
    """The step's control Jacobian Fu comes out 1% off where the step
    kernel produces it."""
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    def altered(out):
        if not isinstance(out, tuple):
            return out
        return (out[0], out[1], out[2] * 1.01)

    step = StepKernel.__call__
    monkeypatch.setattr(StepKernel, "__call__",
                        lambda self, *a: altered(step(self, *a)))


def _one_iteration(monkeypatch):
    """The solve is cut to one iteration, whatever the settings ask."""
    from agimus_controller_tpu_torch.solver.fddp_batch import BatchFDDP

    init = BatchFDDP.__init__

    def cut(self, *a, **k):
        init(self, *a, **k)
        self.settings = dataclasses.replace(self.settings, max_iters=1)

    monkeypatch.setattr(BatchFDDP, "__init__", cut)


def _no_step_accepted(monkeypatch):
    """The line search never accepts a step: the solve hands back its warm
    start."""
    from agimus_controller_tpu_torch.solver.fddp_batch import BatchFDDP

    monkeypatch.setattr(BatchFDDP, "_accept",
                        lambda self, alpha, cost, cost_a, finite, *a:
                        torch.zeros_like(finite))


FAULTS = {"step_unchanged": _step_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "one_iteration": _one_iteration,
          "no_step_accepted": _no_step_accepted}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = run_small(cell)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = run_small(cell)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= SMALL[cell]["batch"]
