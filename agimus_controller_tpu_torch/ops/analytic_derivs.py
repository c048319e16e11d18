"""Analytic RNEA partial derivatives (closed form, batched component layout).

The solvers need stage Jacobians of the forward dynamics
``fd(q, v, tau) = M~^{-1} (tau - rnea(q, v, 0))`` via the RNEA identity

    d a / d(q,v) = -M~^{-1} * d rnea(q, v, a) / d(q, v)      (a held fixed)

The same module as the JAX package's `ops/analytic_derivs.py` (it uses
only the component helpers, so it ports unchanged): the closed-form
derivatives of the recursive Newton-Euler algorithm — the analytical-
derivative formulation the reference gets from Pinocchio's
``computeRNEADerivatives`` (SURVEY.md N3; Carpentier & Mansard, "Analytical
derivatives of rigid body dynamics algorithms", RSS 2018; Singh, Russell &
Wensing's spatial-vector form, RA-L 2022) — re-derived here for the batched
scalar-component layout of `ops/batched_dynamics.py`.

Derivation sketch (world-frame Plucker coordinates at the world origin, so
joint motion subspaces add without transforms).  With s_j the world joint
axis twist, v_j / a_j world body velocity / acceleration, and
f_k^b = I_k a_k + v_k x* I_k v_k the per-body bias force:

    d v_i / d q_j  = s_j x (v_i - v_{lam(j)})            (j ancestor-or-self)
    d a_i / d q_j  = s_j x (a_i - a_{lam(j)})
                     + (v_{lam(j)} x s_j) x (v_i - v_{lam(j)})
    d v_i / d qd_j = s_j
    d a_i / d qd_j = s_j x (v_i - v_{lam(j)}) + v_{lam(j)} x s_j

Expanding d f_k^b and summing over subtrees, the cross terms collapse (two
exact cancellations via the Jacobi identity and (a x b)x* = a x* b x* -
b x* a x*) into FOUR per-subtree composites, all accumulated by plain
addition in world coordinates:

    IC_m  = sum I_k                (composite spatial inertia)
    fA_m  = sum f_k^b              (composite force, free from RNEA)
    H_m   = sum I_k v_k            (composite momentum)
    V1_m  = sum I_k [v_k x]        (6x6 velocity-weighted inertia)

and per-joint 6-vectors (xi_j = v_{lam(j)} x s_j):

    b1_j = a_{lam(j)} x s_j + v_{lam(j)} x xi_j
    b3_j = v_{lam(j)} x s_j
    d_j  = s_j x* fA_j - V1_j xi_j + IC_j b1_j + (cfs(H_j) - V1_j^T) b3_j
    dd_j = (cfs(H_j) - V1_j - V1_j^T) s_j + IC_j (b3_j + xi_j)

(`cfs(h) x = x x* h` is the force cross as a linear map of the motion x, and
W1 = sum [v_k x*] I_k = -V1^T.)  The final entries are outer-product cheap:

    j descendant-or-self of i:   dtau_i/dq_j  = < s_i, d_j >
                                 dtau_i/dqd_j = < s_i, dd_j >
    j strict ancestor of i:      dtau_i/dq_j  = <IC_i s_i, b1_j>
                                                - <V1_i^T s_i, xi_j>
                                                - <(cfs(H_i)+V1_i) s_i, b3_j>
                                 dtau_i/dqd_j = <IC_i s_i, b3_j + xi_j>
                                                - <(V1_i^T + cfs(H_i)+V1_i) s_i, s_j>
    unrelated branches:          0

The j-strict-ancestor rows drop the s x* fA term because the axis s_i itself
rotates with q_j ((s_j x s_i)^T f cancels s_i^T (s_j x* f) exactly).

Cost: ~5k mul per batch lane for the Panda (vs ~25k+ for the nj reverse
sweeps), all fused elementwise over [B].  Supports branched trees and
prismatic joints (Tiago-Pro, free-flyer chart).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from .batched_dynamics import (
    _StaticModel,
    _add,
    _cross,
    _dot,
    _joint_transforms,
    _matmul,
    _matvec,
    _scale,
    _sub,
)

Vec6 = Tuple  # (w: Vec3, u: Vec3) pair of 3-tuples of [B] scalars


def _madd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def _v6_add(a: Vec6, b: Vec6) -> Vec6:
    return (_add(a[0], b[0]), _add(a[1], b[1]))


def _v6_sub(a: Vec6, b: Vec6) -> Vec6:
    return (_sub(a[0], b[0]), _sub(a[1], b[1]))


def _v6_scale(s, a: Vec6) -> Vec6:
    return (_scale(s, a[0]), _scale(s, a[1]))


def _v6_dot(a: Vec6, b: Vec6):
    return _dot(a[0], b[0]) + _dot(a[1], b[1])


def _mcross(a: Vec6, b: Vec6) -> Vec6:
    """Spatial motion cross product a x b."""
    w, u = a
    return (
        _cross(w, b[0]),
        _add(_cross(w, b[1]), _cross(u, b[0])),
    )


def _fcross(a: Vec6, f: Vec6) -> Vec6:
    """Spatial force cross product a x* f (a motion, f force (n, lin))."""
    w, u = a
    n, fl = f
    return (
        _add(_cross(w, n), _cross(u, fl)),
        _cross(w, fl),
    )


def _rot_sym(R, I):
    """R I R^T for a symmetric 3x3 I (both 9-tuples row-major)."""
    return _matmul(_matmul(R, I), _transpose3(R))


def _transpose3(R):
    return (R[0], R[3], R[6], R[1], R[4], R[7], R[2], R[5], R[8])


class _WorldInertia:
    """Per-body spatial inertia about the WORLD origin: (m, c, J) with
    m the (static) mass, c the world CoM position, J = I_C^w the 3x3
    about-CoM rotational inertia in world orientation.  Apply:
        f_lin = m (u + w x c) ;  n = J w + c x f_lin
    which is the spatial-inertia product [[J - m cx cx, m cx], [-m cx, m]]."""

    __slots__ = ("m", "c", "J")

    def __init__(self, m, c, J):
        self.m, self.c, self.J = m, c, J

    def apply(self, mot: Vec6) -> Vec6:
        w, u = mot
        fl = _scale(self.m, _add(u, _cross(w, self.c)))
        n = _add(_matvec(self.J, w), _cross(self.c, fl))
        return (n, fl)


class _CompositeInertia:
    """Composite spatial inertia about the world origin, accumulated by
    addition: blocks [[J, hc x], [-hc x, M]] with M = sum m (static),
    hc = sum m c, J = sum (I_Ck^w - m_k [c_k x][c_k x])."""

    __slots__ = ("M", "hc", "J")

    def __init__(self, M, hc, J):
        self.M, self.hc, self.J = M, hc, J

    @staticmethod
    def from_body(bi: _WorldInertia) -> "_CompositeInertia":
        m, c = bi.m, bi.c
        # -m [cx][cx] = m (|c|^2 I - c c^T)
        c2 = _dot(c, c)
        J = list(bi.J)
        for i in range(3):
            for j in range(3):
                J[3 * i + j] = J[3 * i + j] - m * c[i] * c[j]
            J[3 * i + i] = J[3 * i + i] + m * c2
        return _CompositeInertia(m, _scale(m, c), tuple(J))

    def iadd(self, o: "_CompositeInertia") -> "_CompositeInertia":
        return _CompositeInertia(
            self.M + o.M, _add(self.hc, o.hc), _madd(self.J, o.J))

    def apply(self, mot: Vec6) -> Vec6:
        w, u = mot
        n = _add(_matvec(self.J, w), _cross(self.hc, u))
        f = _add(_scale(self.M, u), _cross(w, self.hc))
        return (n, f)


def _cross_basis(w) -> Tuple:
    """(w x e_x, w x e_y, w x e_z) in closed form (structural zeros are
    python 0.0 so they fold at trace time)."""
    return (
        (0.0, w[2], -w[1]),
        (-w[2], 0.0, w[0]),
        (w[1], -w[0], 0.0),
    )


def _mot_basis_cross(v: Vec6) -> List[Vec6]:
    """Columns of [v x]: [v x] e_j for the 6 motion basis vectors."""
    w, u = v
    wb, ub = _cross_basis(w), _cross_basis(u)
    z3 = (0.0, 0.0, 0.0)
    return [(wb[0], ub[0]), (wb[1], ub[1]), (wb[2], ub[2]),
            (z3, wb[0]), (z3, wb[1]), (z3, wb[2])]


class _Mat66:
    """Dense 6x6 of [B] scalars, stored as 36-list row-major over
    (angular, linear) x (angular, linear)."""

    __slots__ = ("a",)

    def __init__(self, a):
        self.a = a

    @staticmethod
    def from_cols(cols: Sequence[Vec6]) -> "_Mat66":
        a = [None] * 36
        for j, (n, f) in enumerate(cols):
            for i in range(3):
                a[6 * i + j] = n[i]
                a[6 * (i + 3) + j] = f[i]
        return _Mat66(a)

    def iadd(self, o: "_Mat66") -> "_Mat66":
        return _Mat66([x + y for x, y in zip(self.a, o.a)])

    def apply(self, mot: Vec6) -> Vec6:
        x = mot[0] + mot[1]  # 6 scalars
        out = [None] * 6
        for i in range(6):
            s = self.a[6 * i] * x[0]
            for j in range(1, 6):
                s = s + self.a[6 * i + j] * x[j]
            out[i] = s
        return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))

    def apply_t(self, mot: Vec6) -> Vec6:
        x = mot[0] + mot[1]
        out = [None] * 6
        for j in range(6):
            s = self.a[j] * x[0]
            for i in range(1, 6):
                s = s + self.a[6 * i + j] * x[i]
            out[j] = s
        return ((out[0], out[1], out[2]), (out[3], out[4], out[5]))


def gravity_torque_with_dq(sm: _StaticModel, q: List, Xs=None,
                           with_dq: bool = True):
    """Gravity torque g(q) = rnea(q, 0, 0) and its Jacobian dg/dq, closed
    form.  At v = a = 0 the general derivatives collapse: every body's
    spatial acceleration is the gravity twist a_root = (0, -g), so

        f_k^b = I_k a_root = (-m_k c_k x g, -m_k g)
        fA_j  = (-hc_j x g, -M_j g)          (composite mass/first moment)
        d_j   = s_j x* fA_j + IC_j (a_root x s_j)
        dg_i/dq_j = <s_i, d_j>               (j descendant-or-self of i)
                  = <IC_i s_i, a_root x s_j> (j strict ancestor of i)

    Returns (g: list of nj [B] arrays, Dg: nested list [i][j]; None when
    not ``with_dq``, for callers that need the cost value only).  Used by
    the control-grav residual pack (reference: `ResidualModelControlGrav`,
    `ocp_croco_generic.py:186-197`) where it replaces nj autodiff tangent
    passes with ~100 fused flops per joint.
    """
    nj = sm.nj
    if Xs is None:
        Xs = _joint_transforms(sm, q)
    zero3 = (0.0, 0.0, 0.0)
    g = sm.gravity
    a_root: Vec6 = (zero3, (-g[0], -g[1], -g[2]))

    Rw: List = [None] * nj
    ow: List = [None] * nj
    s: List = [None] * nj
    for i in range(nj):
        R, p = Xs[i]
        par = sm.parents[i]
        if par >= 0:
            Rw[i] = _matmul(Rw[par], R)
            ow[i] = _add(ow[par], _matvec(Rw[par], p))
        else:
            Rw[i], ow[i] = R, p
        axw = _matvec(Rw[i], sm.axis[i])
        if sm.types[i] == "revolute":
            s[i] = (axw, _cross(ow[i], axw))
        else:
            s[i] = (zero3, axw)

    # composite inertias + composite gravity wrench, accumulated bottom-up
    IC: List[_CompositeInertia] = [None] * nj
    for i in reversed(range(nj)):
        cabs = _add(ow[i], _matvec(Rw[i], sm.com[i]))
        Jw = _rot_sym(Rw[i], sm.inertia[i])
        IC_i = _CompositeInertia.from_body(_WorldInertia(sm.mass[i], cabs, Jw))
        for c in range(i + 1, nj):
            if sm.parents[c] == i:
                IC_i = IC_i.iadd(IC[c])
        IC[i] = IC_i

    gvec = (g[0], g[1], g[2])
    fA = [(_scale(-1.0, _cross(IC[j].hc, gvec)),
           _scale(-IC[j].M, gvec)) for j in range(nj)]
    tau = [_v6_dot(s[i], fA[i]) for i in range(nj)]
    if not with_dq:
        return tau, None

    b1 = [_mcross(a_root, s[j]) for j in range(nj)]
    d = [_v6_add(_fcross(s[j], fA[j]), IC[j].apply(b1[j]))
         for j in range(nj)]
    u1 = [IC[i].apply(s[i]) for i in range(nj)]

    anc = [set() for _ in range(nj)]
    for i in range(nj):
        p = sm.parents[i]
        while p >= 0:
            anc[i].add(p)
            p = sm.parents[p]

    Dg = [[0.0] * nj for _ in range(nj)]
    for i in range(nj):
        for j in range(nj):
            if j == i or i in anc[j]:
                Dg[i][j] = _v6_dot(s[i], d[j])
            elif j in anc[i]:
                Dg[i][j] = _v6_dot(u1[i], b1[j])
    return tau, Dg


def rnea_qv_derivatives(sm: _StaticModel, q: List, v: List, a: List,
                        Xs=None):
    """Closed-form d rnea(q, v, a)/dq and /dv at fixed joint acceleration a.

    q/v/a: lists (len nj) of [B] arrays.  Returns (Dq, Dv): nested lists with
    Dq[i][j] = d tau_i / d q_j, entries [B] arrays (python 0.0 where the pair
    is structurally zero on unrelated branches).
    """
    nj = sm.nj
    if Xs is None:
        Xs = _joint_transforms(sm, q)
    zero3 = (0.0, 0.0, 0.0)
    zero6 = (zero3, zero3)

    # ---- forward: world frames, twists, velocities, accelerations --------
    Rw: List = [None] * nj   # 9-tuple world rotation of joint frame
    ow: List = [None] * nj   # 3-tuple world origin
    s: List = [None] * nj    # Vec6 world joint subspace twist
    vw: List = [None] * nj   # Vec6 world body velocity
    aw: List = [None] * nj   # Vec6 world body (spatial) acceleration
    g = sm.gravity
    a_root: Vec6 = (zero3, (-g[0], -g[1], -g[2]))
    for i in range(nj):
        R, p = Xs[i]
        par = sm.parents[i]
        Rp = Rw[par] if par >= 0 else (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)
        op = ow[par] if par >= 0 else zero3
        # local (R, p): child->parent rotation, origin offset in parent frame
        Rw[i] = _matmul(Rp, R) if par >= 0 else R
        ow[i] = _add(op, _matvec(Rp, p)) if par >= 0 else p
        axw = _matvec(Rw[i], sm.axis[i])
        if sm.types[i] == "revolute":
            s[i] = (axw, _cross(ow[i], axw))
        else:
            s[i] = (zero3, axw)
        vp = vw[par] if par >= 0 else zero6
        ap = aw[par] if par >= 0 else a_root
        vw[i] = _v6_add(vp, _v6_scale(v[i], s[i]))
        # a_i = a_par + s qdd + (v_i x s) qd
        aw[i] = _v6_add(
            _v6_add(ap, _v6_scale(a[i], s[i])),
            _v6_scale(v[i], _mcross(vw[i], s[i])),
        )

    # ---- per-body world inertias, momenta, bias forces -------------------
    body_I: List[_WorldInertia] = [None] * nj
    h: List[Vec6] = [None] * nj
    fb: List[Vec6] = [None] * nj
    for i in range(nj):
        cabs = _add(ow[i], _matvec(Rw[i], sm.com[i]))
        Jw = _rot_sym(Rw[i], sm.inertia[i])
        bi = _WorldInertia(sm.mass[i], cabs, Jw)
        body_I[i] = bi
        h[i] = bi.apply(vw[i])
        fb[i] = _v6_add(bi.apply(aw[i]), _fcross(vw[i], h[i]))

    # ---- subtree composites (plain addition in world coords) -------------
    fA: List[Vec6] = [None] * nj
    H: List[Vec6] = [None] * nj
    IC: List[_CompositeInertia] = [None] * nj
    V1: List[_Mat66] = [None] * nj
    for i in reversed(range(nj)):
        fA_i, H_i = fb[i], h[i]
        IC_i = _CompositeInertia.from_body(body_I[i])
        V1_i = _Mat66.from_cols(
            [body_I[i].apply(col) for col in _mot_basis_cross(vw[i])])
        for c in range(i + 1, nj):
            if sm.parents[c] == i:
                fA_i = _v6_add(fA_i, fA[c])
                H_i = _v6_add(H_i, H[c])
                IC_i = IC_i.iadd(IC[c])
                V1_i = V1_i.iadd(V1[c])
        fA[i], H[i], IC[i], V1[i] = fA_i, H_i, IC_i, V1_i

    # ---- per-joint vectors ----------------------------------------------
    d: List[Vec6] = [None] * nj     # q-case, j descendant-or-self rows
    dd: List[Vec6] = [None] * nj    # v-case, j descendant-or-self rows
    b1: List[Vec6] = [None] * nj
    b3: List[Vec6] = [None] * nj
    xi: List[Vec6] = [None] * nj
    g1: List[Vec6] = [None] * nj
    u1: List[Vec6] = [None] * nj    # IC_i s_i
    u2: List[Vec6] = [None] * nj    # -V1_i^T s_i
    u3: List[Vec6] = [None] * nj    # -(cfs(H_i) + V1_i) s_i
    for j in range(nj):
        par = sm.parents[j]
        vl = vw[par] if par >= 0 else zero6
        al = aw[par] if par >= 0 else a_root
        sj = s[j]
        xi_j = _mcross(vl, sj)
        b1_j = _v6_add(_mcross(al, sj), _mcross(vl, xi_j))
        b3_j = _mcross(vl, sj)  # == xi_j; kept separate for clarity
        xi[j], b1[j], b3[j] = xi_j, b1_j, b3_j
        g1[j] = _v6_add(b3_j, xi_j)
        cfsH_b3 = _fcross(b3_j, H[j])
        d[j] = _v6_add(
            _v6_sub(_fcross(sj, fA[j]), V1[j].apply(xi_j)),
            _v6_add(IC[j].apply(b1_j),
                    _v6_sub(cfsH_b3, V1[j].apply_t(b3_j))),
        )
        dd[j] = _v6_add(
            _v6_sub(_fcross(sj, H[j]),
                    _v6_add(V1[j].apply(sj), V1[j].apply_t(sj))),
            IC[j].apply(g1[j]),
        )
        u1[j] = IC[j].apply(sj)  # IC symmetric
        u2[j] = _v6_scale(-1.0, V1[j].apply_t(sj))
        u3[j] = _v6_scale(-1.0, _v6_add(_fcross(sj, H[j]), V1[j].apply(sj)))

    # ---- ancestor structure (static) -------------------------------------
    anc = [set() for _ in range(nj)]  # strict ancestors of i
    for i in range(nj):
        p = sm.parents[i]
        while p >= 0:
            anc[i].add(p)
            p = sm.parents[p]

    Dq = [[0.0] * nj for _ in range(nj)]
    Dv = [[0.0] * nj for _ in range(nj)]
    for i in range(nj):
        si = s[i]
        for j in range(nj):
            if j == i or i in anc[j]:  # j descendant-or-self of i
                Dq[i][j] = _v6_dot(si, d[j])
                Dv[i][j] = _v6_dot(si, dd[j])
            elif j in anc[i]:  # j strict ancestor of i
                Dq[i][j] = (_v6_dot(u1[i], b1[j]) + _v6_dot(u2[i], xi[j])
                            + _v6_dot(u3[i], b3[j]))
                Dv[i][j] = (_v6_dot(u1[i], g1[j])
                            + _v6_dot(_v6_add(u2[i], u3[i]), s[j]))
    return Dq, Dv
