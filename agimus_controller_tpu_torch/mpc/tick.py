"""Fused MPC tick: warm-start shift + ring gather + solve, device-resident.

The reference's 100 Hz `run_callback`
(`agimus_controller_ros/agimus_controller.py:474-523`), with everything that
iterates per tick on the device:

    host:    pack the (typically one) new reference row, ship it + x0
    device:  gather horizon rows from the ring  (refs update, O(1)/tick —
             the `problem.circularAppend` analog, `ocp_croco_generic.py:865`)
             shift the previous solution by one base dt   (warm start,
             `warm_start_shift_previous_solution.py:85-109` semantics)
             batch-SQP solve                              (the runtime solver)
    host:    read back (K[0], us[0], stats)               (the control msg)

The previous solution (xs, us), the dual carry y and the ring read slot stay
on the device between ticks; `FusedTickRunner.fetch()` is the one host read
of the control message. Port of the JAX package's `mpc/tick.py`, where the
tick is one jitted program: here the solver's loops run on the host and read
their "all done" flags (`BatchSQP.host_syncs`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ocp.spec import ProblemSpec
from ..ops.batched_dynamics import _StaticModel
from ..ops.cuda_dynamics import euler_step
from ..solver.csqp import CSQPSettings
from ..solver.sqp_batch import make_batch_sqp
from .ring import RefRing, gather_horizon_rows


class TickOutput(NamedTuple):
    # device-resident carry (stays on device between ticks)
    xs: torch.Tensor  # [T+1, nx]
    us: torch.Tensor  # [T, nu]
    y: torch.Tensor  # [T+1, max(nc, 1)] ADMM duals (next tick's warm start)
    next_slot: torch.Tensor  # read slot after consuming the head (device)
    # the control message payload (small; fetched per tick)
    K0: torch.Tensor  # [nu, nx]
    u0: torch.Tensor  # [nu]
    kkt: torch.Tensor
    iters: torch.Tensor
    converged: torch.Tensor


class FusedTick:
    """`tick(ring_arr, read_slot, base_refs, x0, xs_prev, us_prev, limit,
    y_prev) -> TickOutput`.

    The warm-start shift matches `WarmStartShiftPreviousSolution.shift`:
    uniform-dt nodes copy the successor (`xs[i]=xs[i+1]`, `us[i]=us[i+1]`),
    nodes inside a coarser segment advance by one BASE dt re-integration
    with the held control (reference `:85-109`)."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, ring: RefRing,
                 settings: CSQPSettings = CSQPSettings(),
                 device: torch.device | str = DEFAULT_DEVICE,
                 backend: str = "auto"):
        device = resolve_device(device)
        ts = np.asarray(spec.timesteps())
        self._dt = float(ts[0])
        self._all_uniform = bool(np.all(ts == self._dt))
        self._uniform = torch.as_tensor(ts == self._dt, device=device)
        hidx, self._cap_mask = ring.gather_spec()
        self._hidx = torch.as_tensor(hidx, device=device)
        self._layout = ring.layout
        self._sm = _StaticModel(model, params)
        self.solver = make_batch_sqp(model, params, spec, settings, device,
                                     backend)

    def shift(self, xs, us):
        if self._all_uniform:
            # pure roll — no dynamics evaluation needed
            return (torch.cat([xs[1:], xs[-1:]], 0),
                    torch.cat([us[1:], us[-1:]], 0))
        # candidate A: copy successor; candidate B: re-integrate at base dt
        # (plain PyTorch on the tensors' device)
        u_mask = self._uniform[:, None]
        xs_reint = euler_step(self._sm, xs[:-1], us, self._dt)
        xs_sh = torch.where(u_mask, xs[1:], xs_reint)
        xs_sh = torch.cat([xs_sh, xs[-1:]], 0)  # terminal repeats
        us_next = torch.cat([us[1:], us[-1:]], 0)
        us_sh = torch.where(u_mask, us_next, us)
        # last uniform node has no successor control: hold it
        us_sh[-1] = us[-1]
        return xs_sh, us_sh

    def __call__(self, ring_arr, read_slot, base_refs, x0, xs_prev, us_prev,
                 limit: int, y_prev) -> TickOutput:
        rows = gather_horizon_rows(ring_arr, read_slot, self._hidx,
                                   self._cap_mask)
        refs = self._layout.unpack_refs(rows, base_refs)
        xs0, us0 = self.shift(xs_prev, us_prev)
        # ADMM dual warm start across ticks (constrained specs): the
        # previous optimum rides the active boundary, so zero-restarted
        # duals would re-discover the active set every tick
        sol = self.solver(x0[None], refs, xs0[None], us0[None], limit,
                          y_prev[None])
        return TickOutput(
            xs=sol.xs[0], us=sol.us[0], y=sol.y[0],
            next_slot=(read_slot + 1) & self._cap_mask,
            K0=sol.K[0, 0], u0=sol.us[0, 0],
            kkt=sol.kkt[0], iters=sol.iters[0], converged=sol.converged[0])


def make_fused_tick(model: RobotModel, params: ModelParams, spec: ProblemSpec,
                    ring: RefRing, settings: CSQPSettings = CSQPSettings(),
                    device: torch.device | str = DEFAULT_DEVICE,
                    backend: str = "auto") -> FusedTick:
    """Build the fused tick for `device` (see `FusedTick`; `backend`, "auto"
    or "xla", is the batch SQP's, `sqp_batch.BatchSQP`)."""
    return FusedTick(model, params, spec, ring, settings, device, backend)


class FusedTickRunner:
    """Minimal runner of the fused tick: owns the device-resident previous
    solution, feeds the ring, publishes (K0, u0).

    `step()` returns the tick's tensors without copying them to the host;
    `fetch()` materializes the control message in one transfer."""

    def __init__(self, model, params, spec, ring: RefRing, base_refs,
                 settings: CSQPSettings = CSQPSettings(),
                 dtype: torch.dtype = torch.float32,
                 device: torch.device | str = DEFAULT_DEVICE,
                 backend: str = "auto"):
        self.device = resolve_device(device)
        self._tick = make_fused_tick(model, params, spec, ring, settings,
                                     self.device, backend)
        self._ring = ring
        self._refs = base_refs
        self._dtype = dtype
        self._nc = max(self._tick.solver.nc, 1)  # dual carry width
        self._T = spec.horizon
        self._xs: Optional[torch.Tensor] = None
        self._us: Optional[torch.Tensor] = None
        self._y: Optional[torch.Tensor] = None  # device dual carry
        self._slot: Optional[torch.Tensor] = None  # device-carried read slot
        self._settings = settings
        self.last: Optional[TickOutput] = None

    @property
    def solver(self):
        return self._tick.solver

    def _tensor(self, a):
        return torch.as_tensor(a, dtype=self._dtype, device=self.device)

    def initialize(self, x0, xs_init, us_init, limit: int = 1000):
        """First solve with the unlimited budget (reference
        `ocp_base_croco.py:160-171`) from a caller-provided warm start."""
        _, slot = self._ring.device_state()
        self._slot = torch.as_tensor(slot, device=self.device)
        return self._run(x0, self._tensor(xs_init), self._tensor(us_init),
                         limit)

    def _run(self, x0, xs, us, limit):
        # ship any newly appended rows (no-op when pre-staged); the read
        # slot stays ON DEVICE across ticks so a steady-state tick uploads
        # nothing but x0 (and x0 may itself be a device tensor)
        if self._slot is None:
            self._slot = torch.as_tensor(self._ring.device_state()[1],
                                         device=self.device)
        ring_arr = self._ring.sync()
        if self._y is None:
            self._y = torch.zeros((self._T + 1, self._nc), dtype=self._dtype,
                                  device=self.device)
        out = self._tick(ring_arr, self._slot, self._refs, self._tensor(x0),
                         xs, us, int(limit), self._y)
        self._xs, self._us, self._y = out.xs, out.us, out.y
        self.last = out
        return out

    def step(self, x0, limit: Optional[int] = None) -> TickOutput:
        """One control tick: solve at the current ring head from the shifted
        previous solution, then consume the head (the `MPC.run` order:
        horizon -> solve -> `buffer.clear_past`)."""
        if self._xs is None:
            raise RuntimeError("call initialize() first")
        out = self._run(
            x0, self._xs, self._us,
            self._settings.max_iters if limit is None else limit)
        self._slot = out.next_slot  # device-side head advance
        self._ring.clear_past()  # host bookkeeping mirror
        return out

    def fetch(self, out: Optional[TickOutput] = None):
        """Materialize a tick's control message on the host (one transfer):
        (K0 [nu, nx], u0 [nu], kkt, iters, converged)."""
        out = out or self.last
        nu, nx = out.K0.shape
        flat = torch.cat([out.K0.reshape(-1), out.u0, out.kkt.reshape(1),
                          out.iters.to(out.kkt.dtype).reshape(1),
                          out.converged.to(out.kkt.dtype).reshape(1)])
        h = flat.cpu().numpy()
        K0 = h[:nu * nx].reshape(nu, nx)
        u0 = h[nu * nx:nu * nx + nu]
        kkt, iters, conv = h[nu * nx + nu:]
        return K0, u0, float(kkt), int(iters), bool(conv)
