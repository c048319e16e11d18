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
    if q[0].dtype == torch.float32:
        # the derivatives in float64: where a node's accelerations are large
        # (a light joint without armature driven hard, as the full
        # Tiago-Pro's wrists) the closed form's float32 sums cancel and lose
        # more of Fx than the kernels' forward tangents do
        up = lambda xs: [t.double() for t in xs]
        q, v, a, dt = up(q), up(v), up(a), dt.double()
        Xs = _joint_transforms(sm, q)
        L = _chol_factor_c(_mass_matrix_cols(sm, Xs), nj)
        fx, fu = _step_derivatives(sm, q, v, a, Xs, L, dt)
        return xnext, [f.float() for f in fx], [f.float() for f in fu]
    return (xnext,) + _step_derivatives(sm, q, v, a, Xs, L, dt)


def _step_derivatives(sm: _StaticModel, q, v, a, Xs, L, dt):
    """(Fx, Fu) of the Euler step at the accelerations a, with the
    Cholesky factor L of the mass matrix, as lists of row-major entries."""
    nj = sm.nj
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
    return fx, fu


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


# the kernels' numbers in `smem_bytes`; must match `ag::KernelId`
KERNEL_IDS = {"K1": 1, "K2": 2, "K3": 3, "K4": 4, "K5a": 5, "K5b": 6}
# shared memory one block may use on Hopper (the opt-in maximum), and the
# static part of K1-K4's (their by-value `ag::RefTable`: an int, padding
# and `MAX_REFS` = 24 entries of 32 bytes)
SMEM_OPTIN_BYTES = 232_448
REF_TABLE_BYTES = 8 + 24 * 32


def _node_lanes(n: int) -> int:
    """`ag::node_lanes`: the power of two >= n, at most 32."""
    return min(32, max(2, 1 << (n - 1).bit_length()))


def _round4(n: int) -> int:
    return (n + 3) & ~3


def smem_bytes(kernel: str, nj: int, consts_len: int, width: int = 0,
               n_items: int = 0) -> int:
    """Shared memory of one block of `kernel` (a `KERNEL_IDS` key) at nj
    joints, with `consts_len` packed constants, a ref row of `width`
    floats and `n_items` cost items: the dynamic part of
    `csrc/stage_kernels.cuh::smem_floats` and K1-K4's static table."""
    nx, c = 2 * nj, _round4(consts_len)
    if kernel in ("K1", "K3"):
        # K1Shape: x, u, dt, Fx, Fu, an item Jacobian, two item vectors, the
        # ref row, per node
        scratch = (nx + nj + 1 + nx * nx + nx * nj + max(6 * nx, nj * nj)
                   + 2 * max(nx, 6) + width)
        floats = c + (128 // _node_lanes(nx)) * scratch
    elif kernel == "K2":
        floats = c + 32 * (2 * nx + nj + 1 + width)
    elif kernel == "K4":
        floats = c + _round4(4 * nx) + 4 * (width + n_items)
    elif kernel in ("K5a", "K5b"):
        derivs = kernel == "K5b"
        npb = 128 // _node_lanes(nx if derivs else nj + 1)
        # K5Shape's node scratch: R, P, M, b (K5a's ends there), then a, L
        # and the joint table
        size = 12 * nj + nj * nj + nj
        if derivs:
            size += nj + nj * nj + 24 * nj
        outs = (_round4(npb * nx * nx) + _round4(npb * nx * nj)
                if derivs else 0)
        floats = (c + _round4(npb * nx) + _round4(npb * nj) + _round4(npb)
                  + _round4(npb * nx) + outs + _round4(npb * size)
                  + 6 * nj * 128)
    else:
        raise ValueError(f"kernel {kernel!r} not in {tuple(KERNEL_IDS)}")
    return 4 * floats + (0 if kernel.startswith("K5") else REF_TABLE_BYTES)


def check_smem(kernel: str, nj: int, consts_len: int, width: int = 0,
               n_items: int = 0):
    """Raises NotImplementedError, with the bytes, where one block of
    `kernel` needs more shared memory than the card gives a block: the one
    joint count or cost model the kernels refuse."""
    need = smem_bytes(kernel, nj, consts_len, width, n_items)
    if need > SMEM_OPTIN_BYTES:
        raise NotImplementedError(
            f"{kernel} at nj={nj}: a block needs {need} bytes of shared "
            f"memory, more than the {SMEM_OPTIN_BYTES} a block may use")


def launch_error(what: str, nj: int, err: int, smem: int) -> RuntimeError:
    """The wrapper's error for a failed launch, with the block's shared
    memory."""
    return RuntimeError(
        f"{what} launch failed: {_build.error_string(nj, err)} (nj={nj}; a "
        f"block takes {smem} bytes of shared memory, {SMEM_OPTIN_BYTES} at "
        "most)")


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
        self.name = "K5b" if derivs else "K5a"
        consts_len = _JSTRIDE * model.nj + 3
        self.smem = smem_bytes(self.name, model.nj, consts_len)
        if self.device.type == "cuda":
            check_smem(self.name, model.nj, consts_len)
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
        lib = _build.load_library(self.nj)
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
            raise launch_error(f"{self.name} step kernel", self.nj, err,
                               self.smem)
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
