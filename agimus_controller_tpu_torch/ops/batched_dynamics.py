"""Component-form rigid-body numerics in plain PyTorch.

Every *scalar* of the rigid-body computation is an `[N]` tensor (one entry
per node); structure dimensions live in Python tuples, and model constants
are Python floats. This is the plain-PyTorch form of the JAX package's
`ops/batched_dynamics.py` component helpers, and the reference math for the
hand-written stage kernels (`csrc/stage_kernels.cuh`).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..models.model import ModelParams, RobotModel

Vec3 = Tuple  # 3-tuple of [N] tensors (or python floats for constants)
Mat3 = Tuple  # 9-tuple, row-major


def _cross(a: Vec3, b: Vec3) -> Vec3:
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _add(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _sub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def _scale(s, a):
    return tuple(s * x for x in a)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _matvec(R: Mat3, v: Vec3) -> Vec3:
    return (
        R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
        R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
        R[6] * v[0] + R[7] * v[1] + R[8] * v[2],
    )


def _mattvec(R: Mat3, v: Vec3) -> Vec3:
    return (
        R[0] * v[0] + R[3] * v[1] + R[6] * v[2],
        R[1] * v[0] + R[4] * v[1] + R[7] * v[2],
        R[2] * v[0] + R[5] * v[1] + R[8] * v[2],
    )


def _matmul(A: Mat3, B: Mat3) -> Mat3:
    out = []
    for i in range(3):
        for j in range(3):
            out.append(
                A[3 * i + 0] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
            )
    return tuple(out)


def _axis_rotation(axis, q) -> Mat3:
    """Rodrigues about a unit axis (python-float components, tensor angle)."""
    x, y, z = axis[0], axis[1], axis[2]
    c = torch.cos(q)
    s = torch.sin(q)
    t = 1.0 - c
    return (
        t * x * x + c, t * x * y - s * z, t * x * z + s * y,
        t * x * y + s * z, t * y * y + c, t * y * z - s * x,
        t * x * z - s * y, t * y * z + s * x, t * z * z + c,
    )


class _StaticModel:
    """Model constants as plain Python floats."""

    def __init__(self, model: RobotModel, params: ModelParams):
        self.nj = model.nj
        self.parents = model.parents
        self.types = model.joint_types
        p = lambda a: tuple(
            float(v) for v in a.detach().to("cpu", torch.float64).reshape(-1))
        self.joint_rot = [p(params.joint_rot[i]) for i in range(model.nj)]
        self.joint_trans = [p(params.joint_trans[i]) for i in range(model.nj)]
        self.axis = [p(params.axis[i]) for i in range(model.nj)]
        self.mass = [float(params.mass[i]) for i in range(model.nj)]
        self.com = [p(params.com[i]) for i in range(model.nj)]
        self.inertia = [p(params.inertia[i]) for i in range(model.nj)]
        self.armature = [float(params.armature[i]) for i in range(model.nj)]
        self.gravity = p(params.gravity)


def _joint_X(sm: _StaticModel, i: int, qi):
    Rj = sm.joint_rot[i]
    pj = sm.joint_trans[i]
    if sm.types[i] == "revolute":
        return _matmul(Rj, _axis_rotation(sm.axis[i], qi)), pj
    ax = sm.axis[i]
    disp = _matvec(Rj, _scale(qi, ax))
    return Rj, _add(pj, disp)


def _joint_transforms(sm: _StaticModel, q: List):
    return [_joint_X(sm, i, q[i]) for i in range(sm.nj)]


def _rnea_c(sm: _StaticModel, q: List, v: List, a: List, Xs=None) -> List:
    """Component-form RNEA. q/v/a: lists of [N] tensors. Returns tau list."""
    nj = sm.nj
    if Xs is None:
        Xs = _joint_transforms(sm, q)
    vels, accs, frcs = [], [], []
    zero3 = (0.0, 0.0, 0.0)
    g = sm.gravity
    for i in range(nj):
        R, p = Xs[i]
        par = sm.parents[i]
        vp = vels[par] if par >= 0 else (zero3, zero3)
        ap = accs[par] if par >= 0 else (zero3, (-g[0], -g[1], -g[2]))
        # motion_act_inv: w = R^T w_p ; v = R^T (v_p - p x w_p)
        wi = _mattvec(R, vp[0])
        vi = _mattvec(R, _sub(vp[1], _cross(p, vp[0])))
        wai = _mattvec(R, ap[0])
        vai = _mattvec(R, _sub(ap[1], _cross(p, ap[0])))
        ax = sm.axis[i]
        if sm.types[i] == "revolute":
            Sw, Sv = ax, zero3
        else:
            Sw, Sv = zero3, ax
        wi = _add(wi, _scale(v[i], Sw))
        vi = _add(vi, _scale(v[i], Sv))
        wai = _add(wai, _scale(a[i], Sw))
        vai = _add(vai, _scale(a[i], Sv))
        # + v x (S qdot)
        sw, sv = _scale(v[i], Sw), _scale(v[i], Sv)
        wai = _add(wai, _cross(wi, sw))
        vai = _add(vai, _add(_cross(wi, sv), _cross(vi, sw)))
        vels.append((wi, vi))
        accs.append((wai, vai))
        # inertia apply + bias: f = I a + v x* (I v)
        m, c, I = sm.mass[i], sm.com[i], sm.inertia[i]

        def iner(mot):
            w, vv = mot
            plin = _scale(m, _add(vv, _cross(w, c)))
            n = _add(_matvec(I, w), _cross(c, plin))
            return n, plin

        hn, hf = iner((wi, vi))
        fn, ff = iner((wai, vai))
        fn = _add(fn, _add(_cross(wi, hn), _cross(vi, hf)))
        ff = _add(ff, _cross(wi, hf))
        frcs.append([fn, ff])
    tau = [None] * nj
    for i in reversed(range(nj)):
        ax = sm.axis[i]
        fn, ff = frcs[i]
        tau[i] = _dot(ax, fn) if sm.types[i] == "revolute" else _dot(ax, ff)
        par = sm.parents[i]
        if par >= 0:
            R, p = Xs[i]
            flp = _matvec(R, ff)
            fnp = _add(_matvec(R, fn), _cross(p, flp))
            frcs[par][0] = _add(frcs[par][0], fnp)
            frcs[par][1] = _add(frcs[par][1], flp)
    return tau


def _mass_matrix_cols(sm: _StaticModel, Xs) -> List[List]:
    """M + diag(armature) via zero-velocity unit-acceleration columns.

    With v = 0 and no gravity, rnea(q, 0, e_j) = M e_j and all velocity
    products vanish: only the subtree at j propagates accelerations and only
    ancestors of j receive forces."""
    nj = sm.nj
    zero3 = (0.0, 0.0, 0.0)
    M = [[None] * nj for _ in range(nj)]
    for j in range(nj):
        ax_j = sm.axis[j]
        if sm.types[j] == "revolute":
            a_j = (ax_j, zero3)
        else:
            a_j = (zero3, ax_j)
        accs = {j: a_j}
        frcs = {}
        for i in range(j, nj):
            if i > j:
                par = sm.parents[i]
                if par not in accs:
                    continue
                R, p = Xs[i]
                ap = accs[par]
                accs[i] = (
                    _mattvec(R, ap[0]),
                    _mattvec(R, _sub(ap[1], _cross(p, ap[0]))),
                )
            m, c, I = sm.mass[i], sm.com[i], sm.inertia[i]
            w, vv = accs[i]
            plin = _scale(m, _add(vv, _cross(w, c)))
            frcs[i] = [_add(_matvec(I, w), _cross(c, plin)), plin]
        # back-substitute forces to ancestors; read off tau at k <= j and
        # at subtree nodes (symmetric fill)
        for i in reversed(range(nj)):
            if i not in frcs:
                continue
            fn, ff = frcs[i]
            ax = sm.axis[i]
            tau_i = _dot(ax, fn) if sm.types[i] == "revolute" else _dot(ax, ff)
            M[i][j] = tau_i
            if i < j:
                M[j][i] = tau_i  # symmetry (only ancestors of j reached here)
            par = sm.parents[i]
            if par >= 0:
                R, p = Xs[i]
                flp = _matvec(R, ff)
                fnp = _add(_matvec(R, fn), _cross(p, flp))
                if par in frcs:
                    frcs[par][0] = _add(frcs[par][0], fnp)
                    frcs[par][1] = _add(frcs[par][1], flp)
                else:
                    frcs[par] = [fnp, flp]
    for i in range(nj):
        for j in range(nj):
            if M[i][j] is None:
                M[i][j] = 0.0  # non-interacting pair (branching trees)
        M[i][i] = M[i][i] + sm.armature[i]
    return M


def make_batched_soft_step(model: RobotModel, params: ModelParams, sc):
    """`step(x [B, nx+nc], u [B, nu], dt [B], active [B]) -> x_next` on the
    force-augmented state x = [q; v; f] (force_feedback_mpc
    `IAMSoftContactAugmented`; JAX `make_batched_soft_step`): the
    single-sample `soft_contact_step` under `torch.func.vmap`."""
    from .soft_contact import soft_contact_step

    return torch.func.vmap(
        lambda x, u, d, a: soft_contact_step(model, params, sc, x, u, d, a))


def make_batched_soft_step_with_derivs(model: RobotModel,
                                       params: ModelParams, sc):
    """`f(x, u, dt, active) -> (x_next, Fx, Fu)` on the augmented state
    (JAX `make_batched_soft_step_with_derivs`). The Jacobians come from
    `torch.func.jacrev` under `vmap`, where the JAX package takes
    `jax.jacfwd` (the module docstring of `ocp/costs.py` says why)."""
    from .soft_contact import soft_contact_step

    def f1(x, u, d, a):
        def step(xx, uu):
            xn = soft_contact_step(model, params, sc, xx, uu, d, a)
            return xn, xn
        (Fx, Fu), xn = torch.func.jacrev(step, argnums=(0, 1),
                                         has_aux=True)(x, u)
        return xn, Fx, Fu

    return torch.func.vmap(f1)
