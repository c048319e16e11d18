"""SO(3)/SE(3) maps and 6-D motion/force operations on tensors: port of
the JAX package's `ops/spatial.py`.

Conventions (as in the JAX package): a placement is the pair ``(R, p)`` with
``x_A = R @ x_B + p``; twists are ``[w; v]``. Every function takes leading
batch dimensions and also runs under `torch.func.vmap`/`jacfwd`.
"""

from __future__ import annotations

import torch


def hat(w):
    """3-vector -> skew-symmetric matrix (so3 hat map)."""
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], dim=-1),
        torch.stack([w[..., 2], z, -w[..., 0]], dim=-1),
        torch.stack([-w[..., 1], w[..., 0], z], dim=-1),
    ], dim=-2)


def exp3(w):
    """so(3) exponential (Rodrigues), Taylor-safe near ||w|| = 0."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def matrix_to_quat(R):
    """Rotation matrix -> quaternion ``[x, y, z, w]``: the candidate of the
    largest of m00, m11, m22 and the trace (the first on ties, as argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    cands = [
        (1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12),
        (m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20),
        (m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01),
        (m21 - m12, m02 - m20, m10 - m01, 1.0 + tr),
    ]
    best = m00
    out = list(cands[0])
    for s, c in zip((m11, m22, tr), cands[1:]):
        take = s > best
        best = torch.where(take, s, best)
        out = [torch.where(take, cc, oo) for cc, oo in zip(c, out)]
    q = torch.stack(out, dim=-1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def log3(R):
    """SO(3) log, quaternion/atan2 route: w = (theta / sin(theta/2)) q_xyz."""
    q = matrix_to_quat(R)
    xyz = q[..., :3]
    # double cover: w >= 0 so theta in [0, pi]
    sign = torch.where(q[..., 3] < 0.0, -1.0, 1.0).to(q.dtype)
    xyz = xyz * sign[..., None]
    c = torch.abs(q[..., 3])
    s2 = torch.sum(xyz * xyz, dim=-1)
    small = s2 < 1e-12
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    theta = 2.0 * torch.atan2(s, c)
    scale = torch.where(small, 2.0 / c + s2 * 0.0, theta / s)
    return scale[..., None] * xyz


def log6(R, p):
    """SE(3) log: placement -> twist ``[w; v]``."""
    w = log3(R)
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    half_t = theta * 0.5
    sin_half_safe = torch.where(small, torch.ones_like(theta), torch.sin(half_t))
    coef = torch.where(
        small, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t) / sin_half_safe) / theta2_safe)
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    Vinv = eye - 0.5 * W + coef[..., None, None] * (W @ W)
    v = torch.einsum("...ij,...j->...i", Vinv, p)
    return torch.cat([w, v], dim=-1)


def exp6(nu):
    """se(3) exponential. ``nu = [w; v]`` -> placement ``(R, p)``."""
    w, v = nu[..., :3], nu[..., 3:]
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2_safe)
    eye = torch.eye(3, dtype=nu.dtype, device=nu.device)
    WW = W @ W
    R = eye + a[..., None, None] * W + b[..., None, None] * WW
    V = eye + b[..., None, None] * W + c[..., None, None] * WW
    return R, _mv(V, v)


def se3_identity(dtype=torch.float32, device=None):
    return (torch.eye(3, dtype=dtype, device=device),
            torch.zeros(3, dtype=dtype, device=device))


def se3_mul(a, b):
    """Compose placements: (R, p) of ``a @ b``."""
    Ra, pa = a
    Rb, pb = b
    return Ra @ Rb, torch.einsum("...ij,...j->...i", Ra, pb) + pa


def se3_inv(m):
    R, p = m
    Rt = torch.swapaxes(R, -1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, p)


def se3_act_point(m, x):
    R, p = m
    return _mv(R, x) + p


def rpy_to_matrix(rpy):
    """URDF roll-pitch-yaw (extrinsic XYZ) -> rotation matrix: Rz Ry Rx."""
    r, pch, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(pch), torch.sin(pch)
    cy, sy = torch.cos(y), torch.sin(y)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                       dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                       dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_to_matrix(q):
    """Quaternion ``[x, y, z, w]`` (pinocchio/eigen order) -> rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = x * x + y * y + z * z + w * w
    s = 2.0 / torch.where(n > 0, n, torch.ones_like(n))
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    row0 = torch.stack([1.0 - (yy + zz), xy - wz, xz + wy], dim=-1)
    row1 = torch.stack([xy + wz, 1.0 - (xx + zz), yz - wx], dim=-1)
    row2 = torch.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _mv(R, x):
    return torch.einsum("...ij,...j->...i", R, x)


def motion_cross(m1, m2):
    """Spatial motion cross product  m1 x m2."""
    w1, v1 = m1[..., :3], m1[..., 3:]
    w2, v2 = m2[..., :3], m2[..., 3:]
    return torch.cat([torch.linalg.cross(w1, w2),
                      torch.linalg.cross(w1, v2) + torch.linalg.cross(v1, w2)],
                     dim=-1)


def motion_cross_force(m, f):
    """Spatial force cross product  m x* f  (dual of motion_cross)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([torch.linalg.cross(w, n) + torch.linalg.cross(v, fl),
                      torch.linalg.cross(w, fl)], dim=-1)


def motion_act(m, nu):
    """Motion vector from frame B to frame A, given the placement
    ``m = (R, p)`` of B in A."""
    R, p = m
    w = _mv(R, nu[..., :3])
    v = _mv(R, nu[..., 3:]) + torch.linalg.cross(p, w)
    return torch.cat([w, v], dim=-1)


def motion_act_inv(m, nu):
    """Motion vector from frame A to frame B (inverse of `motion_act`)."""
    R, p = m
    Rt = torch.swapaxes(R, -1, -2)
    w_a = nu[..., :3]
    w = _mv(Rt, w_a)
    v = _mv(Rt, nu[..., 3:] - torch.linalg.cross(p, w_a))
    return torch.cat([w, v], dim=-1)


def force_act(m, f):
    """Force vector from frame B to frame A, given ``m = (R, p)``."""
    R, p = m
    fl = _mv(R, f[..., 3:])
    n = _mv(R, f[..., :3]) + torch.linalg.cross(p, fl)
    return torch.cat([n, fl], dim=-1)


def force_act_inv(m, f):
    """Force vector from frame A to frame B (inverse of `force_act`)."""
    R, p = m
    Rt = torch.swapaxes(R, -1, -2)
    fl_a = f[..., 3:]
    n = _mv(Rt, f[..., :3] - torch.linalg.cross(p, fl_a))
    return torch.cat([n, _mv(Rt, fl_a)], dim=-1)


def inertia_apply(mass, com, I_com, nu):
    """Body spatial inertia (mass, CoM offset, rotational inertia about the
    CoM, in the body frame) applied to a local motion ``[w; v]``: the
    momentum ``[n; f]`` about the body origin."""
    w, v = nu[..., :3], nu[..., 3:]
    p_lin = mass[..., None] * (v + torch.linalg.cross(w, com))
    n = _mv(I_com, w) + torch.linalg.cross(com, p_lin)
    return torch.cat([n, p_lin], dim=-1)
