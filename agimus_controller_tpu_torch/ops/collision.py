"""Capsule/sphere signed distances with branch-free Ericson clamps.

Port of the JAX package's `ops/collision.py` (colmpc
`ResidualDistanceCollision` + the capsule narrow phase). A capsule is a
placement (R, p), a radius and a half length along its local z axis; half
length 0 is a sphere, so one formula serves every pair.
"""

from __future__ import annotations

import torch

from ..models.model import ModelParams, RobotModel
from . import spatial
from .kinematics import joint_placements


def _segment_closest_params(p1, d1, l1, p2, d2, l2):
    """Closest points between segments p1 + s*d1 (s in [-l1, l1]) and
    p2 + t*d2 (t in [-l2, l2]). Returns (s, t)."""
    r = p1 - p2
    a = torch.sum(d1 * d1, dim=-1)
    e = torch.sum(d2 * d2, dim=-1)
    b = torch.sum(d1 * d2, dim=-1)
    c = torch.sum(d1 * r, dim=-1)
    f = torch.sum(d2 * r, dim=-1)
    denom = a * e - b * b
    denom_safe = torch.where(denom < 1e-9, torch.ones_like(denom), denom)
    s = torch.where(denom < 1e-9, torch.zeros_like(denom),
                    (b * f - c * e) / denom_safe)
    s = torch.clamp(s, -l1, l1)
    e_safe = torch.where(e < 1e-12, torch.ones_like(e), e)
    t = (b * s + f) / e_safe
    t_cl = torch.clamp(t, -l2, l2)
    # re-project s for the clamped t
    a_safe = torch.where(a < 1e-12, torch.ones_like(a), a)
    s = torch.clamp((b * t_cl - c) / a_safe, -l1, l1)
    return s, t_cl


def capsule_capsule_distance(R1, p1, r1, l1, R2, p2, r2, l2):
    """Signed distance between two capsules given world placements
    (negative when penetrating)."""
    d1 = R1[..., :, 2]
    d2 = R2[..., :, 2]
    s, t = _segment_closest_params(p1, d1, l1, p2, d2, l2)
    c1 = p1 + s[..., None] * d1
    c2 = p2 + t[..., None] * d2
    dist = torch.sqrt(torch.sum((c1 - c2) ** 2, dim=-1) + 1e-12)
    return dist - r1 - r2


def geometry_placements(model: RobotModel, params: ModelParams, q):
    """World placements of all collision geometries: ([ng,3,3], [ng,3]).

    World-fixed geometries (parent_joint == -1) take their rows of
    ``params.geom_rot/geom_trans``; moving obstacles override those rows."""
    rots, trans = joint_placements(model, params, q)
    out_R, out_p = [], []
    for g in model.geometries:
        gR, gp = params.geom_rot[g.index], params.geom_trans[g.index]
        if g.parent_joint < 0:
            out_R.append(gR)
            out_p.append(gp)
        else:
            R, p = spatial.se3_mul(
                (rots[g.parent_joint], trans[g.parent_joint]), (gR, gp))
            out_R.append(R)
            out_p.append(p)
    return torch.stack(out_R), torch.stack(out_p)


def pair_distance(model: RobotModel, params: ModelParams, q, pair_id: int):
    """Signed distance of collision pair ``pair_id``."""
    i, j = model.collision_pairs[pair_id]
    gR, gp = geometry_placements(model, params, q)
    return capsule_capsule_distance(
        gR[i], gp[i], params.geom_radius[i], params.geom_halflen[i],
        gR[j], gp[j], params.geom_radius[j], params.geom_halflen[j])


def all_pair_distances(model: RobotModel, params: ModelParams, q):
    """Signed distances of every registered collision pair, `[n_pairs]`,
    from one kinematics pass."""
    gR, gp = geometry_placements(model, params, q)
    ds = [capsule_capsule_distance(
        gR[i], gp[i], params.geom_radius[i], params.geom_halflen[i],
        gR[j], gp[j], params.geom_radius[j], params.geom_halflen[j])
        for (i, j) in model.collision_pairs]
    return torch.stack(ds) if ds else torch.zeros((0,), dtype=q.dtype,
                                                  device=q.device)
