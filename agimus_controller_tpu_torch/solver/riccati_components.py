"""Batch-minor Riccati backward pass and its small-matrix helpers.

Every tensor is stored with the scenario batch as the MINOR dimension —
`Vxx [nx, nx, B]`, `Fx [nx, nx, B]` — as in the JAX package's
`solver/riccati_components.py`, so the sweeps of `sqp_batch` and
`fddp_batch` read the same way. Small-matrix products are
broadcast-multiply-reduce; the Cholesky and the triangular solves are
unrolled scalar recurrences over `[B]` vectors. `backward_components` is the
FDDP backward sweep (JAX `riccati_components.py:85-148`), and the plain
version of the sweep kernel `ops/cuda_riccati.py`, which the batch FDDP
launches once a sweep on the card for a rigid state.
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


def backward_components(Fx, Fu, lx, lu, lxx, lxu, luu, fs, term_lx, term_lxx,
                        reg):
    """FDDP backward Riccati sweep (Crocoddyl FDDP with gap folding),
    batch-minor layout.

    Args (dense, time-major): Fx [T,B,nx,nx], Fu [T,B,nx,nu], lx [T,B,nx],
    lu [T,B,nu], lxx [T,B,nx,nx], lxu [T,B,nx,nu], luu [T,B,nu,nu],
    fs [T+1,B,nx] dynamics gaps, term_lx [B,nx], term_lxx [B,nx,nx],
    reg [B] Levenberg-Marquardt parameter.

    Returns (ks [T,B,nu], Ks [T,B,nu,nx], Qus [T,B,nu], d1 [B], d2 [B],
    bad [B]), as the dense sweep of `fddp_batch`."""
    T, B, nx, nu = Fu.shape
    # relayout once, outside the loop: batch into the minor dimension
    Fx_t = Fx.permute(0, 2, 3, 1)      # [T, nx, nx, B]
    Fu_t = Fu.permute(0, 2, 3, 1)      # [T, nx, nu, B]
    lx_t = lx.permute(0, 2, 1)         # [T, nx, B]
    lu_t = lu.permute(0, 2, 1)
    lxx_t = lxx.permute(0, 2, 3, 1)
    lxu_t = lxu.permute(0, 2, 3, 1)    # [T, nx, nu, B]
    luu_t = luu.permute(0, 2, 3, 1)
    fnext_t = fs[1:].permute(0, 2, 1)  # [T, nx, B]
    eye_u = torch.eye(nu, dtype=Fx.dtype, device=Fx.device)[:, :, None]

    Vx = term_lx.transpose(0, 1)       # [nx, B]
    Vxx = term_lxx.permute(1, 2, 0)    # [nx, nx, B]
    d1 = d2 = Fx.new_zeros(B)
    ks_t, Ks_t, Qus_t = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        Fxn, Fun = Fx_t[t], Fu_t[t]
        Vxp = Vx + _mv(Vxx, fnext_t[t])                 # [nx, B]
        Qx = lx_t[t] + _mv_T(Fxn, Vxp)                  # [nx, B]
        Qu = lu_t[t] + _mv_T(Fun, Vxp)                  # [nu, B]
        M = _mm(Vxx, Fxn)                               # Vxx Fx  [nx, nx, B]
        N = _mm(Vxx, Fun)                               # Vxx Fu  [nx, nu, B]
        Qxx = lxx_t[t] + _mm_T1(Fxn, M)                 # [nx, nx, B]
        # Qux = lxu^T + Fu^T (Vxx Fx)
        Qux = lxu_t[t].transpose(0, 1) + _mm_T1(Fun, M)  # [nu, nx, B]
        Quu = luu_t[t] + _mm_T1(Fun, N)                 # [nu, nu, B]
        Quu = Quu + reg[None, None, :] * eye_u
        L = _chol_lanes(Quu, nu)
        kk = _chol_solve_lanes(L, Qu[:, None, :], nu)[:, 0, :]  # [nu, B]
        KK = _chol_solve_lanes(L, Qux, nu)              # [nu, nx, B]
        Vx = Qx - _mv_T(Qux, kk)                        # Qux^T kk
        QK = _mm_T1(Qux, KK)                            # Qux^T KK
        Vxx = Qxx - 0.5 * (QK + QK.transpose(0, 1))
        d1 = d1 + (Qu * kk).sum(0)
        d2 = d2 + (kk[:, None, :] * Quu * kk[None, :, :]).sum((0, 1))
        ks_t[t], Ks_t[t], Qus_t[t] = kk, KK, Qu
    ks_t, Ks_t, Qus_t = torch.stack(ks_t), torch.stack(Ks_t), torch.stack(Qus_t)
    bad = ~(torch.isfinite(ks_t).all(1).all(0)
            & torch.isfinite(Ks_t).all(2).all(1).all(0))
    return (ks_t.permute(0, 2, 1), Ks_t.permute(0, 3, 1, 2),
            Qus_t.permute(0, 2, 1), d1, d2, bad)
