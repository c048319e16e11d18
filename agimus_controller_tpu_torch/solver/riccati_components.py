"""Batch-minor small-matrix helpers of the Riccati sweeps.

Every tensor is stored with the scenario batch as the MINOR dimension —
`Vxx [nx, nx, B]`, `Fx [nx, nx, B]` — as in the JAX package's
`solver/riccati_components.py`, so the sweeps of `sqp_batch` read the same
way. Small-matrix products are broadcast-multiply-reduce; the Cholesky and
the triangular solves are unrolled scalar recurrences over `[B]` vectors.
"""

from __future__ import annotations

import torch


def _mm(A, B_):
    """[n, m, B] @ [m, p, B] -> [n, p, B]."""
    return (A[:, :, None, :] * B_[None, :, :, :]).sum(1)


def _mm_T1(A, B_):
    """A^T @ B with A [m, n, B], B [m, p, B] -> [n, p, B]."""
    return (A[:, :, None, :] * B_[:, None, :, :]).sum(0)


def _mv(A, v):
    """[n, m, B] @ [m, B] -> [n, B]."""
    return (A * v[None, :, :]).sum(1)


def _mv_T(A, v):
    """A^T @ v with A [m, n, B], v [m, B] -> [n, B]."""
    return (A * v[:, None, :]).sum(0)


def _chol_lanes(A, n):
    """Cholesky of SPD A [n, n, B] -> rows list L[i][j] of [B] vectors."""
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = torch.sqrt(s)
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = A[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    return L


def _chol_solve_lanes(L, rhs, n):
    """Solve (L L^T) X = rhs with rhs [n, p, B] -> [n, p, B]."""
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[i][k][None, :] * y[k]
        y[i] = s / L[i][i][None, :]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i][None, :] * x[k]
        x[i] = s / L[i][i][None, :]
    return torch.stack(x, 0)
