"""Rigid-body kinematics and dynamics of the reference: forward kinematics,
the recursive Newton-Euler inverse dynamics, the composite-rigid-body mass
matrix, the forward dynamics with armature and the semi-implicit Euler step
(Featherstone, "Rigid Body Dynamics Algorithms", 2008, ch. 5-6, with 6x6
spatial matrices in motion order [w; v]).

Every function takes any leading batch dimensions (none, under
`torch.func.vmap`). Every matrix product goes through `Robot.mm`, so one
switch computes the whole reference with TF32 products (`tf32=True`: both
operands rounded to 10 explicit mantissa bits, the sum kept in float32, as
a tensor core computes a TF32 product); the rounding is applied to values
only, derivatives pass through it unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from .urdf import Tree

GRAVITY = (0.0, 0.0, -9.81)


def round_tf32(x):
    """`x` (float32) rounded to TF32's 10 explicit mantissa bits, to
    nearest (Veltkamp's split at 13 bits)."""
    c = x * 8193.0
    return c - (c - x)


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """[..., 3] -> [..., 3, 3] with skew(v) @ w = v x w."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1),
                        torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


class Robot:
    """A `Tree`'s constants as tensors of `dtype` on `device`, with the
    kinematics and dynamics over them."""

    def __init__(self, tree: Tree, armature, dtype=torch.float64,
                 device="cpu", tf32: bool = False):
        if tf32 and dtype != torch.float32:
            raise ValueError("TF32 products are float32 products")
        self.tree, self.nj = tree, tree.nj
        self.parents = list(tree.parents)
        self.types = list(tree.joint_types)
        self.dtype, self.device, self.tf32 = dtype, torch.device(device), tf32
        t = lambda a: torch.as_tensor(np.array(a, dtype=np.float64),
                                      dtype=dtype, device=self.device)
        self.fixed_rot = t(np.stack(tree.fixed_rot))
        self.fixed_trans = t(np.stack(tree.fixed_trans))
        self.axes = t(np.stack(tree.axes))
        self.inertias = t(np.stack(tree.inertias))
        self.armature = t(np.broadcast_to(np.asarray(armature, float),
                                          (self.nj,)))
        S = np.zeros((self.nj, 6))  # motion subspace: [k; 0] or [0; k]
        for i, (kind, ax) in enumerate(zip(tree.joint_types, tree.axes)):
            if kind == "revolute":
                S[i, :3] = ax
            else:
                S[i, 3:] = ax
        self.S = t(S)
        self.a0 = t(np.concatenate([np.zeros(3), -np.asarray(GRAVITY)]))
        self.frame_data = {name: (j, t(R), t(p))
                           for name, (j, R, p) in tree.frames.items()}

    # -- products --------------------------------------------------------
    def mm(self, a, b):
        if self.tf32:
            a = a + (round_tf32(a) - a).detach()
            b = b + (round_tf32(b) - b).detach()
        return torch.matmul(a, b)

    def mv(self, A, x):
        return self.mm(A, x[..., None])[..., 0]

    # -- kinematics ------------------------------------------------------
    def joint_placement(self, q, i):
        """(R, p) of joint i's frame in its parent joint's frame."""
        R0, p0, k = self.fixed_rot[i], self.fixed_trans[i], self.axes[i]
        qi = q[..., i]
        if self.types[i] == "prismatic":
            return (R0.expand(q.shape[:-1] + (3, 3)),
                    p0 + self.mv(R0, k * qi[..., None]))
        K = skew(k).expand(q.shape[:-1] + (3, 3))
        s, c = torch.sin(qi)[..., None, None], torch.cos(qi)[..., None, None]
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        rot = eye + s * K + (1.0 - c) * self.mm(K, K)
        return self.mm(R0, rot), p0.expand(q.shape[:-1] + (3,))

    def motion_transform(self, R, p):
        """[..., 6, 6] from a parent frame to a child frame at (R, p)."""
        Rt = R.transpose(-1, -2)
        z = torch.zeros_like(R)
        return torch.cat([torch.cat([Rt, z], -1),
                          torch.cat([-self.mm(Rt, skew(p)), Rt], -1)], -2)

    def placements(self, q):
        """World placements (R, p) of every joint frame."""
        out = []
        for i in range(self.nj):
            R, p = self.joint_placement(q, i)
            lam = self.parents[i]
            if lam >= 0:
                Rl, pl = out[lam]
                R, p = self.mm(Rl, R), pl + self.mv(Rl, p)
            out.append((R, p))
        return out

    def frame_placement(self, q, name):
        """World placement (R, p) of a named frame (a link of the URDF)."""
        j, Rf, pf = self.frame_data[name]
        if j < 0:
            return (Rf.expand(q.shape[:-1] + (3, 3)),
                    pf.expand(q.shape[:-1] + (3,)))
        R, p = self.placements(q)[j]
        return self.mm(R, Rf), p + self.mv(R, pf)

    # -- dynamics --------------------------------------------------------
    def _transforms(self, q):
        return [self.motion_transform(*self.joint_placement(q, i))
                for i in range(self.nj)]

    def rnea(self, q, v, a, X=None):
        """Joint torques of the accelerations `a` at (q, v), gravity
        included (the base accelerates up at g); armature not included."""
        X = self._transforms(q) if X is None else X
        vel, acc, force = [], [], []
        for i in range(self.nj):
            lam, S = self.parents[i], self.S[i]
            vJ = S * v[..., i, None]
            if lam >= 0:
                vi = self.mv(X[i], vel[lam]) + vJ
                ai = self.mv(X[i], acc[lam])
            else:
                vi = vJ
                ai = self.mv(X[i], self.a0.expand(q.shape[:-1] + (6,)))
            w = vi[..., :3]
            ai = ai + S * a[..., i, None] + torch.cat(
                [cross(w, vJ[..., :3]),
                 cross(w, vJ[..., 3:]) + cross(vi[..., 3:], vJ[..., :3])], -1)
            h = self.mv(self.inertias[i], vi)
            fi = self.mv(self.inertias[i], ai) + torch.cat(
                [cross(w, h[..., :3]) + cross(vi[..., 3:], h[..., 3:]),
                 cross(w, h[..., 3:])], -1)
            vel.append(vi)
            acc.append(ai)
            force.append(fi)
        tau = [None] * self.nj
        for i in reversed(range(self.nj)):
            tau[i] = (self.S[i] * force[i]).sum(-1)
            lam = self.parents[i]
            if lam >= 0:
                force[lam] = force[lam] + self.mv(X[i].transpose(-1, -2),
                                                  force[i])
        return torch.stack(tau, -1)

    def gravity_torque(self, q):
        z = torch.zeros_like(q)
        return self.rnea(q, z, z)

    def mass_matrix(self, q, X=None):
        """M(q) by the composite-rigid-body algorithm (no armature)."""
        X = self._transforms(q) if X is None else X
        shape = q.shape[:-1]
        Ic = [self.inertias[i].expand(shape + (6, 6)) for i in range(self.nj)]
        for i in reversed(range(self.nj)):
            lam = self.parents[i]
            if lam >= 0:
                Ic[lam] = Ic[lam] + self.mm(
                    X[i].transpose(-1, -2), self.mm(Ic[i], X[i]))
        M = [[None] * self.nj for _ in range(self.nj)]
        for i in range(self.nj):
            F = self.mv(Ic[i], self.S[i].expand(shape + (6,)))
            M[i][i] = (self.S[i] * F).sum(-1)
            j = i
            while self.parents[j] >= 0:
                F = self.mv(X[j].transpose(-1, -2), F)
                j = self.parents[j]
                M[i][j] = M[j][i] = (self.S[j] * F).sum(-1)
        zero = torch.zeros_like(q[..., 0])
        return torch.stack([torch.stack([m if m is not None else zero
                                         for m in row], -1) for row in M], -2)

    def forward_dynamics(self, q, v, u):
        """a = (M(q) + diag(armature))^-1 (u - rnea(q, v, 0)), by a Cholesky
        factor."""
        X = self._transforms(q)
        bias = self.rnea(q, v, torch.zeros_like(v), X)
        M = self.mass_matrix(q, X) + torch.diag(self.armature)
        L = torch.linalg.cholesky(M)
        return torch.cholesky_solve((u - bias)[..., None], L)[..., 0]

    def step(self, x, u, dt):
        """Semi-implicit Euler: v+ = v + a dt, q+ = q + v+ dt."""
        nj = self.nj
        q, v = x[..., :nj], x[..., nj:]
        a = self.forward_dynamics(q, v, u)
        dt = torch.as_tensor(dt, dtype=x.dtype, device=x.device)
        v_next = v + a * dt[..., None]
        return torch.cat([q + v_next * dt[..., None], v_next], -1)
