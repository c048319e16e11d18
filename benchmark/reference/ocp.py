"""The optimal-control problem of the reference: the cost items of a
configuration, their values and Gauss-Newton derivatives, the dynamics'
Jacobians and a dense Riccati pass.

A cost item is weight * 0.5 * sum(w * r^2) with unit activation weights w
(the configurations stream none), over the residual of its kind:

- "state":              r = x - xref
- "control_grav":       r = u - g(q)
- "frame_placement":    r = log6(Mref^-1 M(q)) = [log3(Rref^T R); V^-1 Rref^T (p - pref)]
- "frame_translation":  r = p(q) - pref

A running node's cost and derivatives are scaled by its dt; the terminal
node has no control and no dt (Crocoddyl's `IntegratedActionModelEuler`).
Derivatives are Gauss-Newton: lx = J^T w r, lxx = J^T diag(w) J, and for
"control_grav" lu = w r, luu = diag(w), lxu = J^T diag(w), with J = dr/dx
taken by forward-mode differentiation.
"""

from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from .model import Robot, skew

SMALL = 1e-14  # sin^2 of the angle below which log3 takes its series
# (scalars keep a trailing axis: torch's forward mode gives a 0-d float32
# tensor combined with a Python float a float64 tangent)


def log3(R):
    """SO(3) log of a rotation away from a half turn: theta / (2 sin theta)
    times vee(R - R^T), theta = atan2(sin, cos)."""
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = 0.25 * (vee * vee).sum(-1, keepdim=True)
    c = 0.5 * (torch.diagonal(R, 0, -2, -1).sum(-1, keepdim=True) - 1.0)
    small = s2 < SMALL
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    fac = torch.where(small, 0.5 + s2 * (1.0 / 12.0),
                      torch.atan2(s, c) / (2.0 * s))
    return fac * vee


def log6(robot: Robot, R, p):
    """SE(3) log of (R, p) as [w; v]: w = log3(R), v = V(w)^-1 p."""
    w = log3(R)
    t2 = (w * w).sum(-1, keepdim=True)[..., None]
    small = t2 < SMALL
    t2s = torch.where(small, torch.ones_like(t2), t2)
    half = 0.5 * torch.sqrt(t2s)
    coef = torch.where(small, 1.0 / 12.0 + t2 * (1.0 / 720.0),
                       (1.0 - half * torch.cos(half) / torch.sin(half)) / t2s)
    W = skew(w)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Vinv = eye - 0.5 * W + coef * robot.mm(W, W)
    return torch.cat([w, robot.mv(Vinv, p)], -1)


class Costs:
    """The running and terminal cost items of a configuration over a
    `Robot`, with their references: `xref` [nx], and per goal frame a
    target rotation and position (`goals`: frame -> (R [3,3], p [3]))."""

    def __init__(self, robot: Robot, running, terminal, xref, goals):
        self.robot = robot
        self.running, self.terminal = list(running), list(terminal)
        t = lambda a: torch.as_tensor(a, dtype=robot.dtype, device=robot.device)
        self.xref = t(xref)
        self.goals = {f: (t(R), t(p)) for f, (R, p) in goals.items()}

    def residual(self, item, x, u):
        r = self.robot
        nj = r.nj
        kind = item["kind"]
        if kind == "state":
            return x - self.xref
        if kind == "control_grav":
            return u - r.gravity_torque(x[..., :nj])
        R, p = r.frame_placement(x[..., :nj], item["frame"])
        Rg, pg = self.goals[item["frame"]]
        if kind == "frame_translation":
            return p - pg
        if kind == "frame_placement":
            RgT = Rg.transpose(-1, -2)
            return log6(r, r.mm(RgT, R), r.mv(RgT, p - pg))
        raise ValueError(f"cost kind {kind!r} is not in the reference")

    def _sum(self, items, x, u):
        total = torch.zeros_like(x[..., 0])
        for item in items:
            res = self.residual(item, x, u)
            total = total + item["weight"] * 0.5 * (res * res).sum(-1)
        return total

    def running_value(self, x, u, dt):
        """dt * l(x, u) of running nodes."""
        return dt * self._sum(self.running, x, u)

    def terminal_value(self, x):
        return self._sum(self.terminal, x, torch.zeros_like(x[..., :self.robot.nj]))

    def _gn(self, items, x, u):
        """(l, lx, lu, lxx, lxu, luu) of one node, Gauss-Newton."""
        nx, nu = x.shape[-1], u.shape[-1]
        l = torch.zeros((), dtype=x.dtype, device=x.device)
        lx = x.new_zeros(nx)
        lu = x.new_zeros(nu)
        lxx = x.new_zeros((nx, nx))
        lxu = x.new_zeros((nx, nu))
        luu = x.new_zeros((nu, nu))
        mm = self.robot.mm
        for item in items:
            w = item["weight"]
            res = self.residual(item, x, u)
            J = jacfwd(lambda xx, item=item: self.residual(item, xx, u))(x)
            l = l + w * 0.5 * (res * res).sum()
            JT = J.transpose(0, 1)
            lx = lx + w * self.robot.mv(JT, res)
            lxx = lxx + w * mm(JT, J)
            if item["kind"] == "control_grav":
                lu = lu + w * res
                luu = luu + w * torch.eye(nu, dtype=x.dtype, device=x.device)
                lxu = lxu + w * JT
        return l, lx, lu, lxx, lxu, luu

    def running_derivs(self, x, u, dt):
        """Per node (l, lx, lu, lxx, lxu, luu) of x [N, nx], u [N, nu],
        dt [N], each scaled by its dt."""
        out = vmap(lambda xx, uu: self._gn(self.running, xx, uu))(x, u)
        return tuple(o * dt.reshape((-1,) + (1,) * (o.dim() - 1)) for o in out)

    def terminal_derivs(self, x):
        """(l, lx, lxx) of terminal nodes x [N, nx]."""
        nu = self.robot.nj
        out = vmap(lambda xx: self._gn(self.terminal, xx,
                                       xx.new_zeros(nu)))(x)
        return out[0], out[1], out[3]


def step_derivs(robot: Robot, x, u, dt):
    """(x+, Fx, Fu) of nodes x [N, nx], u [N, nu], dt [N]."""
    def one(xx, uu, d):
        return robot.step(xx, uu, d)
    Fx, Fu = vmap(jacfwd(one, argnums=(0, 1)))(x, u, dt)
    return robot.step(x, u, dt), Fx, Fu


def riccati(robot: Robot, Fx, Fu, lx, lu, lxx, lxu, luu, fs, term_lx,
            term_lxx, reg):
    """Dense backward pass over rows: every argument has a leading row
    axis, then time ([R, T, ...]; fs [R, T+1, nx]); reg [R]. Returns the
    feedback gains K [R, T, nu, nx] (du = -k - K dx), the feed-forward
    terms k [R, T, nu] and Qu [R, T, nu]."""
    mm, mv = robot.mm, robot.mv
    T, nu = Fu.shape[1], Fu.shape[-1]
    eye = torch.eye(nu, dtype=Fx.dtype, device=Fx.device)
    Vx, Vxx = term_lx, term_lxx
    Ks, ks, Qus = [None] * T, [None] * T, [None] * T
    for t in reversed(range(T)):
        A, B = Fx[:, t], Fu[:, t]
        At, Bt = A.transpose(-1, -2), B.transpose(-1, -2)
        Vxp = Vx + mv(Vxx, fs[:, t + 1])
        Qx = lx[:, t] + mv(At, Vxp)
        Qu = lu[:, t] + mv(Bt, Vxp)
        VA = mm(Vxx, A)
        Qxx = lxx[:, t] + mm(At, VA)
        Qux = lxu[:, t].transpose(-1, -2) + mm(Bt, VA)
        Quu = luu[:, t] + mm(Bt, mm(Vxx, B)) + reg[:, None, None] * eye
        K = torch.linalg.solve(Quu, Qux)
        k = torch.linalg.solve(Quu, Qu[..., None])[..., 0]
        Vx = Qx - mv(Qux.transpose(-1, -2), k)
        Vxx = Qxx - mm(Qux.transpose(-1, -2), K)
        Vxx = 0.5 * (Vxx + Vxx.transpose(-1, -2))
        Ks[t], ks[t], Qus[t] = K, k, Qu
    return torch.stack(Ks, 1), torch.stack(ks, 1), torch.stack(Qus, 1)
