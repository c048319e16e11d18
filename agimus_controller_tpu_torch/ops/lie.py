"""Quaternion Lie-group free-flyer state (singularity-free floating base).

Port of the JAX package's `ops/lie.py`. The model factory's
``free_flyer=True`` realizes the floating base as a 6-single-DoF chart (3
prismatic + 3 euler-ZYX revolute, `models/urdf.py::build_model_from_urdf`),
which is exact away from the euler singularity at pitch = +-pi/2. This
module provides the global, singularity-free state on top of it, the
reference's `StateMultibody` free-flyer semantics (nq = 7 + n with a unit
quaternion, tangent dim nv = 6 + n, Lie-group integrate/difference):

    q = [p (3, world), quat (4, xyzw), q_joints (n)]          nq = n + 7
    v = [v_base (3, BODY), w_base-chart-rates (3), vq (n)]    nv = n + 6

Chart re-centering: every dynamics or kinematics evaluation rebuilds the
6-DoF chart at the current base pose (the chart's mount placement becomes
(R_base, p_base), evaluated at chart coordinates 0, where the chart is exact
and furthest from its singularity). The rigid-body functions run unchanged
on the chart model; only the mount placement in `ModelParams` changes per
evaluation. At the chart center the chart rates coincide with the body
twist, so velocities and accelerations need no conversion.

`state_integrate` is the R3 x SO(3) retraction, `state_difference` its
inverse. Single-sample functions (they run under `torch.func.vmap`). Where
the JAX package keeps a square root off 0 with `+ 1e-300`, which is 0 in
float32, the port takes the series branch's argument in the other branch
too, so reverse-mode derivatives stay finite at the identity; the values
are the same.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import dynamics as dyn

N_FF = 6  # chart dofs (tx ty tz rz ry rx, models/urdf.py ff_spec)


# ---------------------------------------------------------------------------
# quaternion utilities ([x, y, z, w], matching ops/spatial.py)
# ---------------------------------------------------------------------------

def quat_to_matrix(q):
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]),
    ])


def quat_normalize(q):
    return q / torch.linalg.vector_norm(q)


def _rot(axis: int, a):
    c, s = torch.cos(a), torch.sin(a)
    o, z = torch.ones_like(a), torch.zeros_like(a)
    rows = {2: ((c, -s, z), (s, c, z), (z, z, o)),
            1: ((c, z, s), (z, o, z), (-s, z, c)),
            0: ((o, z, z), (z, c, -s), (z, s, c))}[axis]
    return torch.stack([torch.stack(r) for r in rows])


def _euler_zyx_to_matrix(e):
    """Chart rotation Rz(e[0]) Ry(e[1]) Rx(e[2]) (ff_spec joint order)."""
    return _rot(2, e[0]) @ _rot(1, e[1]) @ _rot(0, e[2])


def _matrix_to_euler_zyx(R):
    """Inverse of `_euler_zyx_to_matrix`; valid for |pitch| < pi/2."""
    sy = torch.clamp(-R[2, 0], -1.0 + 1e-12, 1.0 - 1e-12)
    return torch.stack([torch.atan2(R[1, 0], R[0, 0]), torch.asin(sy),
                        torch.atan2(R[2, 1], R[2, 2])])


def _hat(w):
    z = torch.zeros_like(w[0])
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def so3_exp(w):
    """Rodrigues: exp([w]x), series coefficients near |w| = 0."""
    th2 = w @ w
    small = th2 < 1e-12
    th2_safe = torch.where(small, torch.ones_like(th2), th2)
    th = torch.sqrt(th2_safe)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2_safe)
    W = _hat(w)
    return torch.eye(3, dtype=w.dtype, device=w.device) + a * W + b * (W @ W)


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion [x, y, z, w]: the candidate of the
    largest of m00, m11, m22 and the trace (the first on ties)."""
    m00, m01, m02 = R[0, 0], R[0, 1], R[0, 2]
    m10, m11, m12 = R[1, 0], R[1, 1], R[1, 2]
    m20, m21, m22 = R[2, 0], R[2, 1], R[2, 2]
    tr = m00 + m11 + m22
    cands = torch.stack([
        torch.stack([1.0 + m00 - m11 - m22, m01 + m10, m02 + m20, m21 - m12]),
        torch.stack([m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21, m02 - m20]),
        torch.stack([m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22, m10 - m01]),
        torch.stack([m21 - m12, m02 - m20, m10 - m01, 1.0 + tr]),
    ])
    q, best = cands[0], m00
    for i, score in ((1, m11), (2, m22), (3, tr)):
        take = score > best
        best = torch.where(take, score, best)
        q = torch.where(take, cands[i], q)
    return q / torch.linalg.vector_norm(q)


def so3_log(R):
    """Rotation-vector log of R, |log| <= pi (the reference's
    `StateMultibody.diff` SO(3) log), through the quaternion with the atan2
    form, stable at both ends of the angle range."""
    q = matrix_to_quat(R)
    q = torch.where(q[3] < 0, -q, q)  # shortest arc (double cover)
    s2 = q[:3] @ q[:3]
    small = s2 < 1e-18
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    angle = 2.0 * torch.atan2(s, q[3])
    # factor = angle / sin(angle/2); series 2/q_w (1 - s^2/(3 q_w^2)) at 0
    qw = torch.clamp(q[3], min=1e-12)
    factor = torch.where(small, 2.0 / qw * (1.0 - s2 / (3.0 * qw * qw)),
                         angle / s)
    return factor * q[:3]


# ---------------------------------------------------------------------------
# free-flyer state
# ---------------------------------------------------------------------------

def ff_dims(model: RobotModel):
    """(nq, nv, nx_global) of the quaternion free-flyer state for a chart
    model (model.nj includes the 6 chart dofs)."""
    n = model.nj - N_FF
    return n + 7, model.nj, n + 7 + model.nj


def split_state(model: RobotModel, x):
    """x [nq+nv] -> (p, quat, qj, v)."""
    n = model.nj - N_FF
    return x[:3], x[3:7], x[7:7 + n], x[7 + n:]


def join_state(p, quat, qj, v):
    return torch.cat([p, quat, qj, v])


def recenter_params(model: RobotModel, params: ModelParams, p, quat):
    """Chart params with the mount placement set to the base pose."""
    jr, jt = params.joint_rot, params.joint_trans
    R = quat_to_matrix(quat).to(jr.dtype)
    return params._replace(joint_rot=torch.cat([R[None], jr[1:]]),
                           joint_trans=torch.cat([p.to(jt.dtype)[None],
                                                  jt[1:]]))


def chart_q(model: RobotModel, qj):
    """Chart configuration at the re-centered base: zeros for the 6 chart
    dofs, then the joint angles."""
    return torch.cat([qj.new_zeros(N_FF), qj])


def q_integrate(model: RobotModel, p, quat, qj, dq):
    """Retract a tangent increment dq [nv] onto the global configuration:
    the R3 x SO(3) direct-product retraction in body-frame coordinates
    (translation steps in the base frame, rotation through the SO(3) exp;
    smooth for any increment)."""
    R = quat_to_matrix(quat)
    p_new = p + R @ dq[:3]
    # chart angular coordinates are (z, y, x)-ordered (ff_spec joint order);
    # at the chart center they equal the body angular velocity components
    # (wz, wy, wx): reordered for the exp map
    R_new = R @ so3_exp(torch.flip(dq[3:6], (0,)))
    return p_new, quat_normalize(matrix_to_quat(R_new)), qj + dq[N_FF:]


def state_integrate(model: RobotModel):
    def integrate(x, dx):
        p, quat, qj, v = split_state(model, x)
        p2, quat2, qj2 = q_integrate(model, p, quat, qj, dx[:model.nj])
        return join_state(p2, quat2, qj2, v + dx[model.nj:])
    return integrate


def state_difference(model: RobotModel):
    def difference(x1, x0):
        p1, quat1, qj1, v1 = split_state(model, x1)
        p0, quat0, qj0, v0 = split_state(model, x0)
        R0 = quat_to_matrix(quat0)
        R1 = quat_to_matrix(quat1)
        dp = R0.T @ (p1 - p0)
        # SO(3) log (valid up to angle pi), reordered into the chart's
        # (z, y, x) angular coordinates
        de = torch.flip(so3_log(R0.T @ R1), (0,))
        return torch.cat([dp, de, qj1 - qj0, v1 - v0])
    return difference


def ff_step(model: RobotModel, params: ModelParams, x, u, dt):
    """Semi-implicit Euler on the quaternion free-flyer state: the dynamics
    on the chart re-centered at the current base pose, the configuration
    update through `q_integrate` with the updated velocity."""
    p, quat, qj, v = split_state(model, x)
    pr = recenter_params(model, params, p, quat)
    a = dyn.forward_dynamics(model, pr, chart_q(model, qj), v, u)
    v_new = v + dt * a
    p2, quat2, qj2 = q_integrate(model, p, quat, qj, dt * v_new)
    return join_state(p2, quat2, qj2, v_new)


def ff_frame_placement(model: RobotModel, params: ModelParams, x, frame_id):
    """World placement (R, p) of an operational frame at a free-flyer
    state."""
    from . import kinematics

    p, quat, qj, _ = split_state(model, x)
    pr = recenter_params(model, params, p, quat)
    return kinematics.frame_placement(model, pr, chart_q(model, qj), frame_id)
