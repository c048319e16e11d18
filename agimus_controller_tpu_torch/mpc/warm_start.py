"""Warm-start strategies (reference L3: `warm_start_base.py:22-92`,
`warm_start_reference.py:11-96`, `warm_start_shift_previous_solution.py:24-109`).

Port of the JAX package's `mpc/warm_start.py`. The warm starts are
host-facing: they take and give numpy arrays. Their numerics (the RNEA along
the reference, the Euler step of the coarse nodes) run on the device that
`setup` is given, in the dtype of the `ModelParams`.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ops import dynamics, integrator
from .buffer import TrajectoryPoint
from .data import OCPResults


def _params_on(params: ModelParams, device: torch.device) -> ModelParams:
    return ModelParams(*(t.to(device) for t in params))


class WarmStartBase(abc.ABC):
    """Abstract warm start (reference `WarmStartBase`)."""

    def __init__(self) -> None:
        self._previous_solution: Optional[OCPResults] = None

    @abc.abstractmethod
    def generate(
        self,
        initial_state: TrajectoryPoint,
        reference_trajectory: List[TrajectoryPoint],
    ) -> Tuple[np.ndarray, List[np.ndarray], List[np.ndarray]]:
        """Returns (x0, x_init [T+1], u_init [T])."""

    @abc.abstractmethod
    def setup(self, *args, **kwargs): ...

    def update_previous_solution(self, previous_solution: OCPResults) -> None:
        self._previous_solution = previous_solution


class WarmStartReference(WarmStartBase):
    """x_init from the reference states, u_init from RNEA inverse dynamics
    along the reference (reference `WarmStartReference`: xs `:68-78`,
    us via `pin.rnea` `:82-88`), the RNEA batched over the horizon with
    `torch.func.vmap`."""

    def __init__(self) -> None:
        super().__init__()
        self._model: Optional[RobotModel] = None
        self._params: Optional[ModelParams] = None
        self._rnea_batch = None

    def setup(self, model: RobotModel, params: ModelParams,
              device: torch.device | str = DEFAULT_DEVICE) -> None:
        device = resolve_device(device)
        self._model = model
        self._params = _params_on(params, device)
        p = self._params
        self._rnea_batch = torch.func.vmap(
            lambda q, v, a: dynamics.rnea(model, p, q, v, a))

    def _tensor(self, a):
        ref = self._params.joint_rot
        return torch.as_tensor(a, dtype=ref.dtype, device=ref.device)

    def generate(self, initial_state, reference_trajectory):
        assert self._model is not None, "call setup() first"
        x0 = initial_state.robot_state
        qs = np.stack([p.robot_configuration for p in reference_trajectory])
        vs = np.stack([p.robot_velocity for p in reference_trajectory])
        accs = np.stack(
            [
                p.robot_acceleration
                if p.robot_acceleration is not None
                else np.zeros_like(p.robot_velocity)
                for p in reference_trajectory
            ]
        )
        # x_init: current state followed by the reference states (ref `:68-78`)
        x_init = [np.asarray(x0)] + [
            p.robot_state for p in reference_trajectory[1:]
        ]
        us = self._rnea_batch(self._tensor(qs), self._tensor(vs),
                              self._tensor(accs)).cpu().numpy()
        u_init = list(us[: len(reference_trajectory) - 1])
        return np.asarray(x0), x_init, u_init


class WarmStartShiftPreviousSolution(WarmStartBase):
    """Shift the previous solution by one base dt; nodes at coarser dt are
    advanced by re-integration (reference
    `warm_start_shift_previous_solution.py:85-109`)."""

    def __init__(self) -> None:
        super().__init__()
        self._timesteps: Optional[np.ndarray] = None
        self._step = None

    def setup(self, model: RobotModel, params: ModelParams, timesteps,
              device: torch.device | str = DEFAULT_DEVICE) -> None:
        device = resolve_device(device)
        self._timesteps = np.asarray(timesteps, dtype=float)
        dt = float(self._timesteps[0])
        assert np.all(self._timesteps >= dt), "timesteps[i] must be >= timesteps[0]"
        p = _params_on(params, device)
        ref = p.joint_rot

        def step(x, u):
            t = lambda a: torch.as_tensor(a, dtype=ref.dtype, device=ref.device)
            return self._node_step(model, p, t(x), t(u), dt).cpu().numpy()

        self._step = step

    def _node_step(self, model, params, x, u, dt):
        """One base-dt step of a coarse node: the cost-free Euler integrator
        (the reference builds a bare IntegratedActionModelEuler for this,
        `:49-62`)."""
        return integrator.euler_step(model, params, x, u, dt)

    def shift(self):
        assert self._previous_solution is not None
        xs = self._previous_solution.states
        us = self._previous_solution.feed_forward_terms
        nb = len(self._timesteps)
        dt = self._timesteps[0]
        xs = np.array(xs)
        us = np.array(us)
        for i, dti in enumerate(self._timesteps):
            if dti == dt:
                xs[i] = xs[i + 1]
                if i < nb - 1:
                    us[i] = us[i + 1]
            else:
                # still inside a coarse segment: advance the node by one base
                # dt with the same control (reference `:99-109`)
                xs[i] = self._step(xs[i], us[i])
        self._previous_solution = OCPResults(
            states=xs, ricatti_gains=self._previous_solution.ricatti_gains,
            feed_forward_terms=us,
        )

    def generate(self, initial_state, reference_trajectory):
        assert self._previous_solution is not None, (
            "update_previous_solution must be called before generate"
        )
        self.shift()
        x0 = initial_state.robot_state
        x_init = list(self._previous_solution.states)
        u_init = list(self._previous_solution.feed_forward_terms)
        return np.asarray(x0), x_init, u_init


class WarmStartShiftPreviousSolutionForceFeedback(WarmStartShiftPreviousSolution):
    """Shift warm start on the force-augmented state x = [q; v; f]
    (reference `warm_start_shift_previous_solution_force_feedback.py:29-98`):
    the integrator of the coarse nodes is the soft-contact step, and x0
    appends the measured contact force masked to the enabled directions
    (`:82-97`)."""

    def setup(self, model: RobotModel, params: ModelParams, timesteps,
              soft_contact, device: torch.device | str = DEFAULT_DEVICE
              ) -> None:
        self._sc = soft_contact
        super().setup(model, params, timesteps, device)

    def _node_step(self, model, params, x, u, dt):
        from ..ops.soft_contact import soft_contact_step

        return soft_contact_step(model, params, self._sc, x, u, dt)

    def generate(self, initial_state, reference_trajectory):
        assert self._previous_solution is not None
        self.shift()
        pt = initial_state
        force = np.zeros(3)
        if pt.forces:
            # single contact frame: the measured wrench's linear part
            force = np.asarray(next(iter(pt.forces.values())))[3:6]
        mask = list(self._sc.mask_indices())
        x0 = np.concatenate([pt.robot_configuration, pt.robot_velocity,
                             force[mask]])
        x_init = list(self._previous_solution.states)
        u_init = list(self._previous_solution.feed_forward_terms)
        return x0, x_init, u_init
