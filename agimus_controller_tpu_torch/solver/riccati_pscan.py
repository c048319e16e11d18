"""Horizon-parallel Riccati: the backward sweep as a log-depth scan over T.

Port of the JAX package's `solver/riccati_pscan.py` (`parallel_riccati`,
which runs `jax.lax.associative_scan`). Each LQR stage k, its control
eliminated, is a conditional value-function element

    e_k = (A_k, b_k, C_k, eta_k, J_k)

with A = Fx - Fu luu^-1 lxu^T, b = gap - Fu luu^-1 lu, C = Fu luu^-1 Fu^T,
and eta / J the (negated) linear and the quadratic value terms of the stage
cost; the terminal element is (0, 0, 0, -lx_T, lxx_T). Composing an earlier
element e1 with a later e2 (`_combine(e2, e1)`, not commutative) is

    D = (I + C1 J2)^-1,  E = (I + J2 C1)^-1
    A = A2 D A1,  b = A2 D (b1 + C1 eta2) + b2,  C = A2 D C1 A2^T + C2
    eta = A1^T E (eta2 - J2 b1) + eta1,  J = A1^T E J2 A1 + J1

and is associative, so the suffix compositions e_k (x) ... (x) e_T give the
value function V_k = (-eta, J) of every node at once; the gains then come
from one node-parallel pass over V_{t+1}.

torch has no associative scan. `value_scan` is a Hillis-Steele reverse
inclusive scan: at level d = 1, 2, 4, ... every element k with k + d <= T
takes `_combine(S[k + d], S[k])`, all of them in one batched combine, so
the scan is ceil(log2(T + 1)) combines deep. A Blelloch up-sweep and
down-sweep does O(T) combines instead of O(T log T) but takes twice the
levels, with strided index sets; on the card the sweep's cost is the chain
of launches, not the arithmetic of the extra combines, so the shorter
chain wins (and each level is a plain slice). Only the current level and
the next are alive at a time.

Every tensor is time-major with the scenarios second, `[T, B, ...]`, as in
`riccati_components.backward_components`, with the regularisation per
scenario. The scan groups products differently from the JAX
`associative_scan` and from the sequential sweep, so the three agree to
round-off, not bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class _Elem(NamedTuple):
    A: torch.Tensor  # [..., nx, nx]
    b: torch.Tensor  # [..., nx]
    C: torch.Tensor  # [..., nx, nx]
    eta: torch.Tensor  # [..., nx]
    J: torch.Tensor  # [..., nx, nx]


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _sym(M):
    return 0.5 * (M + M.transpose(-1, -2))


def _cholesky(M):
    """Lower Cholesky factor; NaN where the factorisation fails (as
    `jnp.linalg.cholesky` gives), never an exception."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where((info > 0)[..., None, None], float("nan"), L)


def _combine(e2: _Elem, e1: _Elem) -> _Elem:
    """Compose e1 (earlier in time) with e2 (later): JAX
    `riccati_pscan._combine`, the same argument order."""
    nx = e1.A.shape[-1]
    eye = torch.eye(nx, dtype=e1.A.dtype, device=e1.A.device)
    eyes = eye.expand(e1.C.shape)
    # `solve_ex`: no error check, so no host sync and no exception (a
    # singular system gives non-finite values, as in JAX)
    D = torch.linalg.solve_ex(eye + e1.C @ e2.J, eyes)[0]
    E = torch.linalg.solve_ex(eye + e2.J @ e1.C, eyes)[0]
    A2D = e2.A @ D
    A = A2D @ e1.A
    b = _mv(A2D, e1.b + _mv(e1.C, e2.eta)) + e2.b
    C = A2D @ e1.C @ e2.A.transpose(-1, -2) + e2.C
    A1TE = e1.A.transpose(-1, -2) @ E
    eta = _mv(A1TE, e2.eta - _mv(e2.J, e1.b)) + e1.eta
    J = _sym(A1TE @ e2.J @ e1.A + e1.J)
    return _Elem(A, b, C, eta, J)


def _stage_elements(lx, lu, lxx, lxu, luu, Fx, Fu, fs_next, reg):
    """The stage elements [T, B, ...], the control eliminated (completing
    the square with luu + reg I)."""
    nu = lu.shape[-1]
    eye_u = torch.eye(nu, dtype=lx.dtype, device=lx.device)
    Lc = _cholesky(luu + reg[None, :, None, None] * eye_u)
    solve_u = lambda Bm: torch.cholesky_solve(Bm, Lc)
    lxuT = lxu.transpose(-1, -2)
    Kc = solve_u(lxuT)  # [T, B, nu, nx]
    kc = solve_u(lu[..., None])[..., 0]  # [T, B, nu]
    return _Elem(
        A=Fx - Fu @ Kc,
        b=fs_next - _mv(Fu, kc),
        C=Fu @ solve_u(Fu.transpose(-1, -2)),
        eta=-(lx - _mv(lxu, kc)),
        J=_sym(lxx - lxu @ Kc))


def _terminal_element(term_lx, term_lxx):
    """The terminal element (0, 0, 0, -lx_T, lxx_T) of every scenario,
    leading [B] (JAX `_terminal_element`)."""
    zero = torch.zeros_like(term_lxx)
    return _Elem(zero, torch.zeros_like(term_lx), zero, -term_lx, term_lxx)


def _reverse_scan(S: _Elem) -> _Elem:
    """Inclusive reverse Hillis-Steele scan over the leading (time) axis:
    element k of the result composes e_k .. e_last."""
    n = S.A.shape[0]
    d = 1
    while d < n:
        # S[k] composes e_k .. e_{k+d-1}; the head takes the next d after it
        head = _combine(_Elem(*(a[d:] for a in S)), _Elem(*(a[:-d] for a in S)))
        S = _Elem(*(torch.cat([h, a[n - d:]], 0) for h, a in zip(head, S)))
        del head
        d *= 2
    return S


def value_scan(lx, lu, lxx, lxu, luu, Fx, Fu, fs, term_lx, term_lxx, reg):
    """The value function of every node, (Vx [T+1, B, nx], Vxx [T+1, B,
    nx, nx]), by the reverse Hillis-Steele scan over the T + 1 elements
    (arguments as `parallel_riccati`)."""
    st = _stage_elements(lx, lu, lxx, lxu, luu, Fx, Fu, fs[1:], reg)
    term = _terminal_element(term_lx, term_lxx)
    S = _reverse_scan(_Elem(*(torch.cat([a, t[None]], 0)
                              for a, t in zip(st, term))))
    return -S.eta, S.J


def _gains_at(lx, lu, lxx, lxu, luu, Fx, Fu, f_next, Vx_n, Vxx_n, reg):
    """The one-shot gain recovery at every node given V_{t+1} (JAX
    `_gains_at`, over leading [T, B]; reg [B]). Returns (ks, Ks, Qus, and
    per node Qu.k and k.Quu.k, the terms of d1 and d2)."""
    nu = lu.shape[-1]
    eye_u = torch.eye(nu, dtype=lx.dtype, device=lx.device)
    FuT = Fu.transpose(-1, -2)
    Vx_plus = Vx_n + _mv(Vxx_n, f_next)
    Qu = lu + _mv(FuT, Vx_plus)
    Qux = lxu.transpose(-1, -2) + FuT @ Vxx_n @ Fx
    Quu = luu + FuT @ Vxx_n @ Fu + reg[None, :, None, None] * eye_u
    L = _cholesky(Quu)
    ks = torch.cholesky_solve(Qu[..., None], L)[..., 0]
    Ks = torch.cholesky_solve(Qux, L)
    return ks, Ks, Qu, (Qu * ks).sum(-1), (ks * _mv(Quu, ks)).sum(-1)


def parallel_riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs, term_lx, term_lxx,
                     reg):
    """FDDP backward pass (gap folding) in O(log T) depth.

    Args, time-major: lx [T,B,nx], lu [T,B,nu], lxx [T,B,nx,nx], lxu
    [T,B,nx,nu], luu [T,B,nu,nu], Fx [T,B,nx,nx], Fu [T,B,nx,nu], fs
    [T+1,B,nx] dynamics gaps (fs[0] unused), term_lx [B,nx], term_lxx
    [B,nx,nx], reg [B].

    Returns (ks [T,B,nu], Ks [T,B,nu,nx], Qus [T,B,nu], d1 [B], d2 [B], bad
    [B]), as `riccati_components.backward_components`: JAX's batch FDDP
    takes the same from `vmap(parallel_riccati)`. `bad` flags a scenario
    with a non-finite gain (a failed factor gives NaN)."""
    Vx, Vxx = value_scan(lx, lu, lxx, lxu, luu, Fx, Fu, fs, term_lx,
                         term_lxx, reg)
    ks, Ks, Qu, d1_t, d2_t = _gains_at(lx, lu, lxx, lxu, luu, Fx, Fu, fs[1:],
                                       Vx[1:], Vxx[1:], reg)
    T, B = ks.shape[:2]
    bad = ~(torch.isfinite(ks).reshape(T, B, -1).all(2).all(0)
            & torch.isfinite(Ks).reshape(T, B, -1).all(2).all(0))
    return ks, Ks, Qu, d1_t.sum(0), d2_t.sum(0), bad
