"""Plain-PyTorch semi-implicit Euler step with its Jacobians, per node.

`dynamics_terms` is the reference math of the device function that the
stage kernels (`csrc/stage_kernels.cuh::stage_node`, wrapped by
`ops/cuda_costs.py`) run for every node: joint transforms, RNEA bias, CRBA
mass matrix, unrolled Cholesky, and Fx/Fu through the RNEA identity

    d a / d(q,v) = -M~^-1 d rnea(q, v, a) / d(q, v)   (a held fixed)
    d a / d tau  =  M~^-1

It ports the JAX package's `ops/pallas_dynamics.py::dynamics_terms`. Where
that function pulls d rnea / d(q, v) back with `jax.vjp`, this one takes the
closed form (`analytic_derivs.rnea_qv_derivatives`); the kernel takes forward
dual numbers, so the plain version and the kernel reach the Jacobian by two
independent routes.
"""

from __future__ import annotations

import torch

from .analytic_derivs import rnea_qv_derivatives
from .batched_dynamics import (
    _StaticModel,
    _joint_transforms,
    _mass_matrix_cols,
    _rnea_c,
)


def _chol_factor_c(M, n):
    """Unrolled scalar Cholesky of an SPD component matrix (list-of-lists)."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = M[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s.sqrt() if i == j else s / L[j][j]
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
