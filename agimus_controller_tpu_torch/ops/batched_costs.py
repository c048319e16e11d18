"""Component-form batched Gauss-Newton cost packs in plain PyTorch.

Port of the JAX package's `ops/batched_costs.py`: the component-form
kinematics and SE(3) log maps that the frame, frame-velocity,
visual-servoing and collision cost kinds need (world joint placements, frame
poses and spatial velocities, rotation -> quaternion, the SO(3)/SE(3) logs,
geometry placements, the capsule distance), and `make_batched_cost_pack`,
the cost side of the batch FDDP. Same component layout as
`batched_dynamics`: every scalar is an `[N]` tensor.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ocp.spec import CostItem, ProblemSpec
from . import activations as act
from .analytic_derivs import gravity_torque_with_dq
from .batched_dynamics import (
    _StaticModel,
    _add,
    _cross,
    _dot,
    _joint_transforms,
    _matmul,
    _mattvec,
    _matvec,
    _scale,
    _sub,
)
from .kinematics import _ancestors as _ancestors_static

SUPPORTED_KINDS = (
    "state",
    "control",
    "control_grav",
    "frame_placement",
    "frame_translation",
    "frame_rotation",
    "frame_velocity",
    "visual_servoing",
    "collision_distance",
)

# residual kinds of x alone (frame_velocity: of q and v) whose Gauss-Newton
# blocks come from residual Jacobians
_X_ONLY_KINDS = (
    "frame_placement",
    "frame_translation",
    "frame_rotation",
    "frame_velocity",
    "visual_servoing",
    "collision_distance",
)


def _fk_world(sm: _StaticModel, q: List):
    """World placements of every joint in component form (unrolled chain)."""
    Xs = _joint_transforms(sm, q)
    oR, op = [], []
    for i in range(sm.nj):
        R, p = Xs[i]
        par = sm.parents[i]
        if par < 0:
            oR.append(R)
            op.append(p)
        else:
            oR.append(_matmul(oR[par], R))
            op.append(_add(_matvec(oR[par], p), op[par]))
    return oR, op


def _quat_c(R):
    """Branchless rotation-matrix -> quaternion [x,y,z,w], component form
    (candidate-select construction: the largest of m00, m11, m22, trace)."""
    m00, m01, m02, m10, m11, m12, m20, m21, m22 = R
    tr = m00 + m11 + m22
    cands = [
        ((1.0 + m00 - m11 - m22), (m01 + m10), (m02 + m20), (m21 - m12)),
        ((m01 + m10), (1.0 - m00 + m11 - m22), (m12 + m21), (m02 - m20)),
        ((m02 + m20), (m12 + m21), (1.0 - m00 - m11 + m22), (m10 - m01)),
        ((m21 - m12), (m02 - m20), (m10 - m01), (1.0 + tr)),
    ]
    scores = [m00, m11, m22, tr]
    best = scores[0]
    out = list(cands[0])
    for s, c in zip(scores[1:], cands[1:]):
        take = s > best
        best = torch.where(take, s, best)
        out = [torch.where(take, cc, oo) for cc, oo in zip(c, out)]
    n = torch.sqrt(out[0] ** 2 + out[1] ** 2 + out[2] ** 2 + out[3] ** 2)
    return tuple(o / n for o in out)


def _log3_c(R):
    """SO(3) log, component form (quaternion / atan2 route)."""
    qx, qy, qz, qw = _quat_c(R)
    sign = torch.where(qw < 0.0, -1.0, 1.0).to(qw.dtype)
    qx, qy, qz = qx * sign, qy * sign, qz * sign
    c = torch.abs(qw)
    s2 = qx * qx + qy * qy + qz * qz
    # float32-robust branch: s2 carries ~1e-12 of rounding noise near the
    # identity, and theta/s vs its 2/c limit agree to ~s2 there — the 1e-8
    # threshold fixes which Jacobian branch is taken
    small = s2 < 1e-8
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = 2.0 * torch.atan2(s, c)
    scale = torch.where(small, 2.0 / c, theta / s)
    return (scale * qx, scale * qy, scale * qz)


def _log6_c(R, p):
    """SE(3) log -> ([w; v] 6-tuple)."""
    w = _log3_c(R)
    t2 = _dot(w, w)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    half = th * 0.5
    sin_half = torch.where(small, torch.ones_like(th), torch.sin(half))
    coef = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half) / sin_half) / t2s)
    # V^-1 p = p - 0.5 w x p + coef * w x (w x p)
    wxp = _cross(w, p)
    wwxp = _cross(w, wxp)
    v = tuple(p[i] - 0.5 * wxp[i] + coef * wwxp[i] for i in range(3))
    return w + v  # 6-tuple


def _frame_pose_c(model: RobotModel, params: ModelParams, oR, op,
                  frame_id: int):
    """(R, p) of frame `frame_id` from world joint placements (components)."""
    fr = model.frames[frame_id]
    fR = tuple(float(x) for x in params.frame_rot[frame_id].reshape(-1))
    fp = tuple(float(x) for x in params.frame_trans[frame_id])
    j = fr.parent_joint
    return _matmul(oR[j], fR), _add(_matvec(oR[j], fp), op[j])


def _frame_velocity_c(model: RobotModel, sm: _StaticModel, oR, op,
                      v: List, frame_id: int, reference_frame: str,
                      Rf, pf):
    """Spatial velocity [w(3); v(3)] 6-tuple of a frame, component form.

    The frame Jacobian times v in the pinocchio conventions (`world`,
    `local`, else `local_world_aligned`), as `kinematics.frame_velocity`."""
    fr = model.frames[frame_id]
    zero3 = (0.0, 0.0, 0.0)
    w, v0 = zero3, zero3  # world spatial twist at the world origin
    for i in _ancestors_static(model, fr.parent_joint):
        ax = sm.axis[i]
        if sm.types[i] == "revolute":
            Sw = _matvec(oR[i], ax)
            col_w = Sw
            col_v = _cross(op[i], Sw)  # R Sv (=0) + p x (R Sw)
        else:
            col_w = zero3
            col_v = _matvec(oR[i], ax)
        w = _add(w, _scale(v[i], col_w))
        v0 = _add(v0, _scale(v[i], col_v))
    if reference_frame == "world":
        return w + v0
    # v at the frame origin: v0 - pf x w  (motion_act_inv's v - p x w term)
    v_at = _sub(v0, _cross(pf, w))
    if reference_frame == "local":
        return _mattvec(Rf, w) + _mattvec(Rf, v_at)
    # local_world_aligned: local parts rotated back to world
    return w + v_at


def _one_below(x, eps):
    """1 where x < eps, else x; x a tensor or, for a world-fixed geometry's
    constant axis, a Python float."""
    if isinstance(x, torch.Tensor):
        return torch.where(x < eps, torch.ones_like(x), x)
    return 1.0 if x < eps else x


def _capsule_distance_c(R1, p1, r1, l1, R2, p2, r2, l2):
    """Signed capsule-capsule distance, component form (the branch-free
    Ericson clamps of `collision.capsule_capsule_distance`)."""
    d1 = (R1[2], R1[5], R1[8])  # local z column
    d2 = (R2[2], R2[5], R2[8])
    r = _sub(p1, p2)
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    b = _dot(d1, d2)
    c = _dot(d1, r)
    f = _dot(d2, r)
    denom = a * e - b * b
    denom_safe = torch.where(denom < 1e-9, torch.ones_like(denom), denom)
    s = torch.where(denom < 1e-9, torch.zeros_like(denom),
                    (b * f - c * e) / denom_safe)
    s = torch.clamp(s, -l1, l1)
    t = (b * s + f) / _one_below(e, 1e-12)
    t_cl = torch.clamp(t, -l2, l2)
    s = torch.clamp((b * t_cl - c) / _one_below(a, 1e-12), -l1, l1)
    c1 = _add(p1, _scale(s, d1))
    c2 = _add(p2, _scale(t_cl, d2))
    diff = _sub(c1, c2)
    dist = torch.sqrt(_dot(diff, diff) + 1e-12)
    return dist - r1 - r2


def _geom_placement_c(model: RobotModel, params: ModelParams, oR, op,
                      gi: int, refs):
    """World placement of collision geometry `gi`, component form. Local
    placements come from the refs overrides `geom_rot`/`geom_trans` when
    present (moving obstacles, the reference's `update_geometry_placement`,
    `ocp_base_croco.py:110-132`), else from the model."""
    g = model.geometries[gi]
    if "geom_rot" in refs:
        gRa = refs["geom_rot"][gi]
        gR = tuple(gRa[r, c] for r in range(3) for c in range(3))
    else:
        gR = tuple(float(x) for x in params.geom_rot[gi].reshape(-1))
    if "geom_trans" in refs:
        gpa = refs["geom_trans"][gi]
        gp = tuple(gpa[i] for i in range(3))
    else:
        gp = tuple(float(x) for x in params.geom_trans[gi])
    if g.parent_joint < 0:
        return gR, gp
    j = g.parent_joint
    return _matmul(oR[j], gR), _add(_matvec(oR[j], gp), op[j])


# ---------------------------------------------------------------------------
# batched Gauss-Newton cost packs
# ---------------------------------------------------------------------------
#
# Derivative blocks are carried as nested Python lists of [N] tensors (or
# the Python float 0.0 for a structural zero, or 0-d tensors and Python
# floats for state-independent entries such as activation weights) and
# written into dense [N, ...] tensors once per pack, as in the JAX package.

def _zero(c) -> bool:
    """A structural zero: a Python float 0.0. A nonzero float is a constant
    entry (e.g. the world axis of a prismatic root joint in a translation
    Jacobian) and takes part in the sums; the JAX pack drops every float
    entry there, so its translation and placement Gauss-Newton blocks miss
    such a joint's column (ROADMAP queue 3)."""
    return isinstance(c, float) and c == 0.0


def _cadd(a, b):
    if isinstance(a, float) and a == 0.0:
        return b
    if isinstance(b, float) and b == 0.0:
        return a
    return a + b


def _cscale(s, a):
    if isinstance(a, float) and a == 0.0:
        return 0.0
    return s * a


def _acc_vec(acc, contrib, wgt):
    return [_cadd(a, _cscale(wgt, c)) for a, c in zip(acc, contrib)]


def _acc_mat(acc, contrib, wgt):
    return [[_cadd(a, _cscale(wgt, c)) for a, c in zip(ar, cr)]
            for ar, cr in zip(acc, contrib)]


def _comp(a, i):
    """Component i of a reference row: `a` is [n] (one node time) or
    [N, n] (per-node times)."""
    return a[..., i]


def _world_joint_twists(model: RobotModel, sm: _StaticModel, fid: int, oR,
                        op):
    """World twist columns (w, v at the origin) of each ancestor joint of
    frame `fid`'s parent joint; None for the other joints (w None for a
    prismatic joint)."""
    cols = [None] * sm.nj
    for k in _ancestors_static(model, model.frames[fid].parent_joint):
        ax = sm.axis[k]
        if sm.types[k] == "revolute":
            wk = _matvec(oR[k], ax)
            cols[k] = (wk, _cross(op[k], wk))
        else:
            cols[k] = (None, _matvec(oR[k], ax))
    return cols


class BatchedCostPack:
    """The running and terminal cost models of a spec as batched
    Gauss-Newton packs (port of the closures of the JAX
    `make_batched_cost_pack`):

        pack(x [N,nx], u [N,nu], t, refs) -> (l, lx, lu, lxx, lxu, luu)
        term_pack(x, refs)                -> (l, lx, lxx)
        value(x, u, t, refs)              -> l
        term_value(x, refs)               -> l

    every output `[N, ...]`, the running ones dt-scaled. ``t`` is a node
    time (int) or an [N] tensor of node times, so one call covers the nodes
    of every time step. The running costs are scaled by a float32 copy of
    the timesteps, in every trajectory dtype, as the JAX pack does at its
    default `dtype` (the only one its callers use). `value` and
    `term_value` skip the derivative work and give the same `l` as the
    packs."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, device: torch.device):
        self.model, self.spec = model, spec
        self.sm = _StaticModel(model, params)
        # host copy of the constants the helpers read (no device reads later)
        self.hp = ModelParams(*(t.detach().to("cpu", torch.float64).numpy()
                                for t in params))
        self.nj = self.sm.nj
        self.nx = 2 * self.nj
        self.timesteps = torch.as_tensor(spec.timesteps(),
                                         dtype=torch.float32, device=device)
        self._static: Dict = {}  # (weights, dtype, device) -> [n] tensor

    # -- per-item terms ----------------------------------------------------
    def _static_weights(self, item: CostItem, n: int, like=None):
        """Static activation weights of `item`: a list of n Python floats,
        or (with `like`) an [n] tensor in its dtype and device, made once."""
        if item.act_weights is None:
            w = [1.0] * n
        else:
            wv = np.asarray(item.act_weights, np.float64).reshape(-1)
            w = [float(v) for v in (wv if wv.shape[0] == n else
                                    np.broadcast_to(wv[:1], (n,)))]
        if like is None:
            return w
        key = (tuple(w), like.dtype, like.device)
        if key not in self._static:
            self._static[key] = torch.as_tensor(w, dtype=like.dtype,
                                                device=like.device)
        return self._static[key]

    def _pose_target(self, item: CostItem, t, refs):
        """(R 9-tuple, p 3-tuple) of a pose item's target at t; the
        visual-servoing target is `wMo · oMf_ref` (`ocp_croco_generic.py:
        436-495`)."""
        Ra = refs[f"ee_rot:{item.frame}"][t]
        pa = refs[f"ee_trans:{item.frame}"][t]
        R = tuple(Ra[..., r, c] for r in range(3) for c in range(3))
        p = tuple(_comp(pa, i) for i in range(3))
        if item.kind != "visual_servoing":
            return R, p
        wR = refs[f"wMo_rot:{item.object_frame}"]
        wp = refs[f"wMo_trans:{item.object_frame}"]
        wRc = tuple(wR[r, c] for r in range(3) for c in range(3))
        return (_matmul(wRc, R),
                _add(_matvec(wRc, p), tuple(wp[i] for i in range(3))))

    def _r_flat(self, item: CostItem, t, refs, xx):
        """Residual [N, nr] of a frame-velocity or collision item at x."""
        model, sm, nj = self.model, self.sm, self.nj
        q = [xx[:, i] for i in range(nj)]
        oR, op = _fk_world(sm, q)
        if item.kind == "frame_velocity":
            fid = model.frame_id(item.frame)
            v = [xx[:, nj + i] for i in range(nj)]
            Rf, pf = _frame_pose_c(model, self.hp, oR, op, fid)
            nu = _frame_velocity_c(model, sm, oR, op, v, fid,
                                   item.reference_frame, Rf, pf)
            ref_nu = refs[f"ee_vel:{item.frame}"][t]
            return torch.stack(tuple(nu[i] - _comp(ref_nu, i)
                                     for i in range(6)), 1)
        if item.kind == "collision_distance":
            hp = self.hp
            gi, gj = model.collision_pairs[item.pair_id]
            R1, p1 = _geom_placement_c(model, hp, oR, op, gi, refs)
            R2, p2 = _geom_placement_c(model, hp, oR, op, gj, refs)
            d = _capsule_distance_c(
                R1, p1, float(hp.geom_radius[gi]), float(hp.geom_halflen[gi]),
                R2, p2, float(hp.geom_radius[gj]), float(hp.geom_halflen[gj]))
            return d[:, None]
        raise ValueError(item.kind)

    def _pose_residual(self, item: CostItem, x, t, refs, derivs: bool):
        """(r [N, nr], Jc [nr][nx] or None) of a frame-placement,
        -translation, -rotation or visual-servoing item: the analytic frame
        Jacobian, with tangents only through the small log map."""
        model, sm, nj, nx = self.model, self.sm, self.nj, self.nx
        nr = item.residual_dim(model)
        fid = model.frame_id(item.frame)
        q = [x[:, i] for i in range(nj)]
        oR, op = _fk_world(sm, q)
        Rf, pf = _frame_pose_c(model, self.hp, oR, op, fid)
        refR, refp = self._pose_target(item, t, refs)
        rRT = (refR[0], refR[3], refR[6], refR[1], refR[4], refR[7],
               refR[2], refR[5], refR[8])
        Jc = [[0.0] * nx for _ in range(nr)]
        if item.kind == "frame_translation":
            r = torch.stack(_sub(pf, refp), 1)
            if not derivs:
                return r, None
            for k, tw in enumerate(_world_joint_twists(model, sm, fid, oR, op)):
                if tw is None:
                    continue
                wk, v0 = tw
                # d p / d q_k = v0 + w x p (velocity of the frame origin
                # under the joint's unit twist)
                dp = _add(v0, _cross(wk, pf)) if wk is not None else v0
                for o in range(3):
                    Jc[o][k] = dp[o]
            return r, Jc
        dR = _matmul(rRT, Rf)
        dp = _matvec(rRT, _sub(pf, refp))
        rot_only = item.kind == "frame_rotation"
        if not derivs:
            r = _log3_c(dR) if rot_only else _log6_c(dR, dp)
            return torch.stack(r, 1), None
        ndelta = 3 if rot_only else 6

        def log_of_delta(delta):
            # D exp(delta) to first order: R' = dR (I + [w x]),
            # p' = dR v + dp; exact at delta = 0 where it is linearised
            wd = (delta[:, 0], delta[:, 1], delta[:, 2])
            wx = (0.0, -wd[2], wd[1],
                  wd[2], 0.0, -wd[0],
                  -wd[1], wd[0], 0.0)
            Rp = _add(dR, _matmul(dR, wx))
            if rot_only:
                return torch.stack(_log3_c(Rp), 1)
            vd = (delta[:, 3], delta[:, 4], delta[:, 5])
            pp = _add(_matvec(dR, vd), dp)
            return torch.stack(_log6_c(Rp, pp), 1)

        zero_d = x.new_zeros((x.shape[0], ndelta))
        Jl = [[None] * ndelta for _ in range(nr)]  # [nr][ndelta] of [N]
        for s_ in range(ndelta):
            e = torch.zeros_like(zero_d)
            e[:, s_] = 1.0
            r, col = torch.func.jvp(log_of_delta, (zero_d,), (e,))
            for o in range(nr):
                Jl[o][s_] = col[:, o]
        # local frame Jacobian rows: delta = Jf dq
        rows = [[0.0] * nj for _ in range(ndelta)]
        RfT = (Rf[0], Rf[3], Rf[6], Rf[1], Rf[4], Rf[7], Rf[2], Rf[5], Rf[8])
        for k, tw in enumerate(_world_joint_twists(model, sm, fid, oR, op)):
            if tw is None:
                continue
            wk, v0 = tw
            if wk is not None:
                wl = _matvec(RfT, wk)
                v_at = _add(v0, _cross(wk, pf))
                for o in range(3):
                    rows[o][k] = wl[o]
            else:
                v_at = v0
            if not rot_only:
                vl = _matvec(RfT, v_at)
                for o in range(3):
                    rows[3 + o][k] = vl[o]
        # Jc = Jlog @ Jf, component MACs
        for o in range(nr):
            for k in range(nj):
                s = 0.0
                for s_ in range(ndelta):
                    if not _zero(rows[s_][k]):
                        s = _cadd(s, Jl[o][s_] * rows[s_][k])
                Jc[o][k] = s
        return r, Jc

    def _residual(self, item: CostItem, x, t, refs, derivs: bool):
        """(r [N, nr], Jc [nr][nx] or None) of an x-only residual kind."""
        if item.kind not in ("frame_velocity", "collision_distance"):
            return self._pose_residual(item, x, t, refs, derivs)
        r_flat = lambda xx: self._r_flat(item, t, refs, xx)
        if not derivs:
            return r_flat(x), None
        nx, nr = self.nx, item.residual_dim(self.model)
        Jc = [[0.0] * nx for _ in range(nr)]
        if item.kind == "collision_distance":
            # scalar residual: one reverse pull instead of nj tangents
            r, pull = torch.func.vjp(r_flat, x)
            (Jx,) = pull(torch.ones_like(r))
            for i in range(self.nj):
                Jc[0][i] = Jx[:, i]
            return r, Jc
        for i in range(nx):  # frame_velocity: a residual of q and v
            e = torch.zeros_like(x)
            e[:, i] = 1.0
            r, col = torch.func.jvp(r_flat, (x,), (e,))
            for o in range(nr):
                Jc[o][i] = col[:, o]
        return r, Jc

    def _act_weights(self, item: CostItem, t, refs, nr, like):
        """Activation weights, [nr] or [N, nr]."""
        if item.update and item.kind in ("frame_placement", "visual_servoing"):
            return refs[f"w_ee:{item.frame}"][t]
        if item.update and item.kind == "frame_rotation":
            return refs[f"w_ee:{item.frame}"][t][..., :3]
        if item.update and item.kind == "frame_translation":
            return refs[f"w_ee:{item.frame}"][t][..., 3:]
        if item.update and item.kind == "frame_velocity":
            return refs[f"w_ee_vel:{item.frame}"][t]
        return self._static_weights(item, nr, like)

    def _item_terms(self, item: CostItem, x, u, t, refs, derivs: bool):
        """-> (l [N], lx_c, lu_c, lxx_c, lxu_c, luu_c) component
        contributions (None where the item has no such block, and every
        block None without ``derivs``)."""
        nj, nx = self.nj, self.nx
        none = (None,) * 5
        if item.kind in ("state", "control"):
            st = item.kind == "state"
            n, z = (nx, x) if st else (nj, u)
            ref_key, w_key = ("xref", "w_x") if st else ("uref", "w_u")
            if item.update:
                ra, wa = refs[ref_key][t], refs[w_key][t]
                ref = [_comp(ra, i) for i in range(n)]
                w = [_comp(wa, i) for i in range(n)]
            else:
                ref = ([float(s) for s in item.static_ref] if item.static_ref
                       else [0.0] * n)
                w = self._static_weights(item, n)
            r_c = [z[:, i] - ref[i] for i in range(n)]
            g_c = [w[i] * r_c[i] for i in range(n)]
            l = 0.5 * sum(g_c[i] * r_c[i] for i in range(n))
            if not derivs:
                return (l,) + none
            hess = [[w[i] if i == j else 0.0 for j in range(n)]
                    for i in range(n)]
            if st:
                return l, g_c, None, hess, None, None
            return l, None, g_c, None, None, hess
        if item.kind == "control_grav":
            if item.update:
                wa = refs["w_u"][t]
                w = [_comp(wa, i) for i in range(nj)]
            else:
                w = self._static_weights(item, nj)
            tau_g, Dg = gravity_torque_with_dq(
                self.sm, [x[:, i] for i in range(nj)], with_dq=derivs)
            r_c = [u[:, i] - tau_g[i] for i in range(nj)]
            wr_c = [w[i] * r_c[i] for i in range(nj)]
            l = 0.5 * sum(wr_c[i] * r_c[i] for i in range(nj))
            if not derivs:
                return (l,) + none
            luu_c = [[w[i] if i == j else 0.0 for j in range(nj)]
                     for i in range(nj)]
            # residual Jacobians: J_u = I, J_x = [-dg/dq, 0]
            lx_c = [0.0] * nx
            lxu_c = [[0.0] * nj for _ in range(nx)]
            lxx_c = [[0.0] * nx for _ in range(nx)]
            for i in range(nj):
                s = 0.0
                for r in range(nj):
                    if not _zero(Dg[r][i]):
                        s = _cadd(s, Dg[r][i] * wr_c[r])
                        lxu_c[i][r] = -(w[r] * Dg[r][i])
                lx_c[i] = _cscale(-1.0, s)
            for i in range(nj):
                for j in range(i, nj):
                    s = 0.0
                    for r in range(nj):
                        if not (_zero(Dg[r][i]) or _zero(Dg[r][j])):
                            s = _cadd(s, w[r] * Dg[r][i] * Dg[r][j])
                    lxx_c[i][j] = s
                    lxx_c[j][i] = s
            return l, lx_c, wr_c, lxx_c, lxu_c, luu_c
        if item.kind not in _X_ONLY_KINDS:
            raise ValueError(item.kind)
        nr = item.residual_dim(self.model)
        r, Jc = self._residual(item, x, t, refs, derivs)
        w = self._act_weights(item, t, refs, nr, x)
        wb = w if w.ndim == 2 else w[None]
        if item.activation == "weighted_quad":
            l = act.weighted_quad_value(r, wb)
            if not derivs:
                return (l,) + none
            a_dr = act.weighted_quad_dr(r, wb)
            a_drr = torch.broadcast_to(wb, r.shape)
        else:
            value, dr, drr = {
                "exp": (act.exp_value, act.exp_dr, act.exp_drr),
                "quad_exp": (act.quad_exp_value, act.quad_exp_dr,
                             act.quad_exp_drr)}[item.activation]
            l = value(r, w, item.act_alpha)
            if not derivs:
                return (l,) + none
            a_dr = dr(r, w, item.act_alpha)
            a_drr = drr(r, w, item.act_alpha)
        adr_c = [a_dr[:, o] for o in range(nr)]
        adrr_c = [a_drr[:, o] for o in range(nr)]
        lx_c = [0.0] * nx
        lxx_c = [[0.0] * nx for _ in range(nx)]
        # scaled rows JW[o][i] = a_drr[o] * Jc[o][i], shared across lxx
        JW = [[_cscale(adrr_c[o], Jc[o][i]) for i in range(nx)]
              for o in range(nr)]
        for i in range(nx):
            s = 0.0
            for o in range(nr):
                if not _zero(Jc[o][i]):
                    s = _cadd(s, Jc[o][i] * adr_c[o])
            lx_c[i] = s
        for i in range(nx):
            for j in range(i, nx):
                s = 0.0
                for o in range(nr):
                    if not (_zero(JW[o][i]) or _zero(Jc[o][j])):
                        s = _cadd(s, JW[o][i] * Jc[o][j])
                lxx_c[i][j] = s
                lxx_c[j][i] = s
        return l, lx_c, None, lxx_c, None, None

    # -- assembly ------------------------------------------------------------
    def _assemble(self, items, x, u, t, refs, derivs: bool):
        """Accumulate all items in component form."""
        nj, nx = self.nj, self.nx
        l = x.new_zeros(x.shape[0])
        lx, lu = [0.0] * nx, [0.0] * nj
        lxx = [[0.0] * nx for _ in range(nx)]
        lxu = [[0.0] * nj for _ in range(nx)]
        luu = [[0.0] * nj for _ in range(nj)]
        for item in items:
            if not item.active:
                continue
            wgt = item.weight
            if item.kind == "collision_distance" and item.update:
                # streamed w_collision_avoidance scale (`trajectory.py:84-158`)
                wgt = wgt * refs["w_coll"][t]
            li, lxi, lui, lxxi, lxui, luui = self._item_terms(
                item, x, u, t, refs, derivs)
            l = l + wgt * li
            if lxi is not None:
                lx = _acc_vec(lx, lxi, wgt)
            if lui is not None:
                lu = _acc_vec(lu, lui, wgt)
            if lxxi is not None:
                lxx = _acc_mat(lxx, lxxi, wgt)
            if lxui is not None:
                lxu = _acc_mat(lxu, lxui, wgt)
            if luui is not None:
                luu = _acc_mat(luu, luui, wgt)
        return l, lx, lu, lxx, lxu, luu

    @staticmethod
    def _dense(comps, x, scale=None):
        """Component list (or list of rows) -> [N, n] (or [N, n, m]) in x's
        dtype; structural zeros stay zero."""
        rows = comps if isinstance(comps[0], list) else [comps]
        out = x.new_zeros((x.shape[0], len(rows), len(rows[0])))
        for i, row in enumerate(rows):
            for j, c in enumerate(row):
                if scale is not None:
                    c = _cscale(scale, c)
                if not (isinstance(c, float) and c == 0.0):
                    out[:, i, j] = c
        return out if isinstance(comps[0], list) else out[:, 0]

    def _dt(self, t, x):
        return self.timesteps[t].to(x.dtype)

    def pack(self, x, u, t, refs):
        dt = self._dt(t, x)
        l, lx, lu, lxx, lxu, luu = self._assemble(
            self.spec.running_costs, x, u, t, refs, True)
        d = lambda c: self._dense(c, x, dt)
        return dt * l, d(lx), d(lu), d(lxx), d(lxu), d(luu)

    def term_pack(self, x, refs):
        u0 = x.new_zeros((x.shape[0], self.nj))
        l, lx, _, lxx, _, _ = self._assemble(
            self.spec.terminal_costs, x, u0, self.spec.horizon, refs, True)
        return l, self._dense(lx, x), self._dense(lxx, x)

    def value(self, x, u, t, refs):
        l = self._assemble(self.spec.running_costs, x, u, t, refs, False)[0]
        return self._dt(t, x) * l

    def term_value(self, x, refs):
        u0 = x.new_zeros((x.shape[0], self.nj))
        return self._assemble(self.spec.terminal_costs, x, u0,
                              self.spec.horizon, refs, False)[0]


def make_batched_cost_pack(model: RobotModel, params: ModelParams,
                           spec: ProblemSpec,
                           device: torch.device | str = DEFAULT_DEVICE):
    """The spec's `BatchedCostPack` on `device`, or None when the spec has a
    cost kind outside SUPPORTED_KINDS, an exp activation on a kind that is
    not a residual of x, or a soft-contact state (JAX
    `batched_costs.py:279-285`)."""
    if spec.soft_contact is not None:
        return None
    for item in spec.all_costs():
        if item.kind not in SUPPORTED_KINDS:
            return None
        if item.activation != "weighted_quad" and item.kind not in _X_ONLY_KINDS:
            return None
    return BatchedCostPack(model, params, spec, resolve_device(device))
