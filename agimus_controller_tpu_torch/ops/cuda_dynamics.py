"""Dynamics-step kernels K5a/K5b and the semi-implicit Euler step per node.

Port of the JAX package's `ops/pallas_dynamics.py`:

    K5a  make_cuda_step         x+                (make_pallas_step)
    K5b  make_cuda_step_derivs  x+, Fx, Fu        (make_pallas_step_derivs)

Each wrapper (`StepKernel`) launches the hand-written CUDA kernel of
`csrc/step_kernels.cu` on CUDA tensors and runs its plain-PyTorch version
(`dynamics_terms`) on CPU tensors; a CUDA tensor reaches the kernel or the
wrapper raises. They are also the port's counterpart of the XLA steps
`ops/batched_dynamics.py::make_batched_step(_with_derivs)`, which have the
same semantics: the port's batch FDDP calls them directly.

`dynamics_terms` is the reference math of the device function
`csrc/stage_kernels.cuh::dynamics_node` that K5a/K5b and the stage kernels
(`ops/cuda_costs.py`) run for every node: joint transforms, RNEA bias, CRBA
mass matrix, unrolled Cholesky, and Fx/Fu through the RNEA identity

    d a / d(q,v) = -M~^-1 d rnea(q, v, a) / d(q, v)   (a held fixed)
    d a / d tau  =  M~^-1

It ports the JAX package's `ops/pallas_dynamics.py::dynamics_terms`. Where
that function pulls d rnea / d(q, v) back with `jax.vjp`, this one takes the
closed form (`analytic_derivs.rnea_qv_derivatives`); the kernels take
forward-mode tangents (dual numbers, or K5b's derivative passes around the
shared primal values), so the plain version and the kernels reach the
Jacobian by two independent routes.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from . import _build
from .analytic_derivs import rnea_qv_derivatives
from .batched_dynamics import (
    _StaticModel,
    _joint_transforms,
    _mass_matrix_cols,
    _rnea_c,
)


def _chol_factor_c(M, n):
    """Unrolled scalar Cholesky of an SPD component matrix (list-of-lists;
    an entry that does not depend on q, such as the diagonal of a joint
    whose subtree is one body, may be a Python float)."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i != j:
                L[i][j] = s / L[j][j]
            else:
                L[i][j] = s.sqrt() if torch.is_tensor(s) else math.sqrt(s)
    return L


def _chol_solve_col(L, bcol, n):
    """Solve (L L^T) x = b for one component column vector."""
    y = [None] * n
    for i in range(n):
        s = bcol[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def dynamics_terms(sm: _StaticModel, q, v, u, dt, with_derivs: bool):
    """Component-form Euler step (+ Fx, Fu via the RNEA identity).

    q/v/u: lists of [N] tensors, dt an [N] tensor. Returns
    (xnext list[nx], fx list[nx*nx] | None, fu list[nx*nj] | None), every
    entry row-major over the Jacobian."""
    nj = sm.nj
    Xs = _joint_transforms(sm, q)
    zero = [q[0].new_zeros(q[0].shape)] * nj
    b = _rnea_c(sm, q, v, zero, Xs)
    M = _mass_matrix_cols(sm, Xs)
    rhs = [u[i] - b[i] for i in range(nj)]
    L = _chol_factor_c(M, nj)
    a = _chol_solve_col(L, rhs, nj)

    xnext = [None] * (2 * nj)
    for i in range(nj):
        vn = v[i] + dt * a[i]
        xnext[nj + i] = vn
        xnext[i] = q[i] + dt * vn
    if not with_derivs:
        return xnext, None, None

    # d rnea(q, v, a)/d(q, v) at fixed a, closed form
    Dq, Dv = rnea_qv_derivatives(sm, q, v, a, Xs)
    one = q[0].new_ones(q[0].shape)
    zero_t = q[0].new_zeros(q[0].shape)
    # Minv columns (unit rhs) and da columns (da[:,k] = -Minv drnea[:,k])
    minv_cols = [
        _chol_solve_col(L, [one if i == j else zero_t for i in range(nj)], nj)
        for j in range(nj)
    ]  # minv_cols[j][i] = Minv[i, j]
    da_cols = [
        _chol_solve_col(
            L, [-(Dq[i][k] if k < nj else Dv[i][k - nj]) + zero_t
                for i in range(nj)], nj)
        for k in range(2 * nj)
    ]  # da_cols[k][i] = d a_i / d qv_k

    # semi-implicit Euler chain rule: v+ = v + dt a ; q+ = q + dt v+
    dt2 = dt * dt
    fx = [None] * (4 * nj * nj)
    fu = [None] * (2 * nj * nj)
    for i in range(nj):
        for k in range(2 * nj):
            da_ik = da_cols[k][i]
            if k < nj:
                fx[i * 2 * nj + k] = (1.0 if k == i else 0.0) + dt2 * da_ik
                fx[(nj + i) * 2 * nj + k] = dt * da_ik
            else:
                fx[i * 2 * nj + k] = (dt if k - nj == i else 0.0) + dt2 * da_ik
                fx[(nj + i) * 2 * nj + k] = (
                    1.0 if k - nj == i else 0.0) + dt * da_ik
        for j in range(nj):
            fu[i * nj + j] = dt2 * minv_cols[j][i]
            fu[(nj + i) * nj + j] = dt * minv_cols[j][i]
    return xnext, fx, fu


def euler_step(sm: _StaticModel, x, u, dt):
    """Semi-implicit Euler step of dense states: x [N, nx], u [N, nj], dt
    scalar or [N] -> x_next [N, nx], on the tensors' own device."""
    nj = sm.nj
    dtt = x.new_zeros(x.shape[0]) + dt
    xn, _, _ = dynamics_terms(
        sm, list(x[:, :nj].unbind(1)), list(x[:, nj:].unbind(1)),
        list(u.unbind(1)), dtt, False)
    return torch.stack(xn, 1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

KERNEL_NJ = (2, 7)  # joint counts the kernels are instantiated for
# packed model constants; must match `csrc/stage_kernels.cuh` (J_*): per
# joint rot 9, trans 3, axis 3, type, parent, mass, com 3, inertia 9,
# armature; then gravity 3
_JSTRIDE = 31


def _pack_model(model: RobotModel, params: ModelParams) -> np.ndarray:
    """Joint constants and gravity as one float64 vector (the head of every
    kernel's packed constants)."""
    nj = model.nj
    P = {f: getattr(params, f).detach().to("cpu", torch.float64).numpy()
         for f in ("joint_rot", "joint_trans", "axis", "mass", "com",
                   "inertia", "armature", "gravity")}
    joints = np.zeros((nj, _JSTRIDE))
    for i in range(nj):
        joints[i, 0:9] = P["joint_rot"][i].reshape(-1)
        joints[i, 9:12] = P["joint_trans"][i]
        joints[i, 12:15] = P["axis"][i]
        joints[i, 15] = 0.0 if model.joint_types[i] == "revolute" else 1.0
        joints[i, 16] = model.parents[i]
        joints[i, 17] = P["mass"][i]
        joints[i, 18:21] = P["com"][i]
        joints[i, 21:30] = P["inertia"][i].reshape(-1)
        joints[i, 30] = P["armature"][i]
    return np.concatenate([joints.reshape(-1), P["gravity"]])


def _check_input(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def dt_per_node(dt, x):
    """dt as the kernels take it, one value per node of x: a Python float
    or a 0-d tensor is broadcast to [N] in x's dtype on x's device (as the
    Pallas kernels broadcast it); an [N] tensor passes as it is."""
    if not isinstance(dt, torch.Tensor):
        return torch.full((x.shape[0],), dt, dtype=x.dtype, device=x.device)
    if dt.ndim == 0:
        return dt.to(device=x.device, dtype=x.dtype).expand(
            x.shape[0]).contiguous()
    return dt


class StepKernel:
    """K5a (derivs=False) / K5b (derivs=True): the semi-implicit Euler step.

    `__call__(x [N,nx], u [N,nj], dt)` with dt a Python float, a 0-d tensor
    or an [N] tensor returns x+ [N,nx], or (x+, Fx [N,nx,nx], Fu [N,nx,nj])
    with derivs, node-major: the shapes of the JAX `make_pallas_step(_derivs)`
    dense entry."""

    def __init__(self, model: RobotModel, params: ModelParams, derivs: bool,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if self.device.type == "cuda" and model.nj not in KERNEL_NJ:
            raise NotImplementedError(
                f"the step kernels are instantiated for nj in {KERNEL_NJ}, "
                f"not {model.nj} (ROADMAP queue 2, item 4)")
        self.nj, self.derivs = model.nj, derivs
        self.sm = _StaticModel(model, params)
        self.launches = 0  # kernel launches (CUDA path only)
        self._consts = None
        if self.device.type == "cuda":
            self._consts = torch.as_tensor(
                _pack_model(model, params).astype(np.float32),
                device=self.device)

    def __call__(self, x, u, dt):
        if x.device.type == "cpu":
            return self.plain(x, u, dt)
        args, outs = self.prepare(x, u, dt)
        self.launch(args)
        return outs if self.derivs else outs[0]

    def prepare(self, x, u, dt):
        """Checks the inputs and allocates the outputs: returns (the
        launch's arguments, the outputs)."""
        if self._consts is None or x.device != self.device:
            raise ValueError(
                f"wrapper built for {self.device}, called with {x.device}")
        lib = _build.load_library()
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        dt = dt_per_node(dt, x)
        for name, t, shape in (("x", x, (N, nx)), ("u", u, (N, nj)),
                               ("dt", dt, (N,))):
            _check_input(name, t, self.device, shape)
        new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
        outs = (new(nx), new(nx, nx), new(nx, nj)) if self.derivs else (new(nx),)
        ptrs = [_ptr(o) for o in outs] + [None] * (3 - len(outs))
        args = (lib, (nj, int(self.derivs), N, _ptr(x), _ptr(u), _ptr(dt),
                      _ptr(self._consts), self._consts.numel(), *ptrs,
                      ctypes.c_void_p(
                          torch.cuda.current_stream(x.device).cuda_stream)),
                (x, u, dt, outs))
        return args, outs

    def launch(self, args):
        """One launch of the kernel on prepared arguments (`prepare`)."""
        lib, cargs, _ = args
        err = lib.ag_step(*cargs)
        if err != 0:
            raise RuntimeError(f"step kernel launch failed: {_build.error_string(err)}")
        self.launches += 1

    def plain(self, x, u, dt):
        """The plain-PyTorch version (`dynamics_terms`), on the inputs' own
        device."""
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        dtt = x.new_zeros(N) + dt
        xn, fx, fu = dynamics_terms(
            self.sm, list(x[:, :nj].unbind(1)), list(x[:, nj:].unbind(1)),
            list(u.unbind(1)), dtt, self.derivs)
        xn = torch.stack(xn, 1)
        if not self.derivs:
            return xn
        zero = x.new_zeros(N)
        dense = lambda comps, shape: torch.stack(
            [c + zero for c in comps], 1).reshape((N,) + shape)
        return xn, dense(fx, (nx, nx)), dense(fu, (nx, nj))


def make_cuda_step(model: RobotModel, params: ModelParams,
                   device: torch.device | str = DEFAULT_DEVICE) -> StepKernel:
    """K5a wrapper for `device`: `step(x, u, dt) -> x+` (see `StepKernel`)."""
    return StepKernel(model, params, False, device)


def make_cuda_step_derivs(model: RobotModel, params: ModelParams,
                          device: torch.device | str = DEFAULT_DEVICE
                          ) -> StepKernel:
    """K5b wrapper for `device`: `f(x, u, dt) -> (x+, Fx, Fu)` (see
    `StepKernel`)."""
    return StepKernel(model, params, True, device)
