"""Fused stage kernels: dynamics + cost Gauss-Newton packs per node (K1-K4).

The SQP iteration's node-parallel work — semi-implicit Euler step, its
Jacobians, and every running-cost residual/gradient/GN-Hessian — happens in
ONE kernel launch per stage. Port of the JAX package's
`ops/pallas_costs.py` (`make_pallas_stage`, `make_pallas_terminal`):

    K1  make_cuda_stage(derivs=True)      x+, Fx, Fu, l, lx, lu, lxx, lxu, luu
    K2  make_cuda_stage(derivs=False)     x+, l          (line-search trial)
    K3  make_cuda_terminal(derivs=True)   l, lx, lxx     (t = T, u = 0, no dt)
    K4  make_cuda_terminal(derivs=False)  l

Each wrapper launches the hand-written CUDA kernel of `csrc/stage_kernels.cu`
(K1/K2) or `csrc/terminal_kernels.cu` (K3/K4)
on CUDA tensors, and runs its plain-PyTorch version (`plain`, the same math
in component form) on CPU tensors. There is no fallback from one to the
other: a CUDA tensor reaches the kernel or the wrapper raises.

The kernels gather each node's references themselves: the wrapper passes
one small source table by value (`RefPlan.table`: per layout key of
`_ref_layout`, the tensor's pointer, row stride and component count) and
the node times (K1/K2) or the horizon (K3/K4), so a call runs no torch op
on refs that are float32 on the device with contiguous components, such as
the tick's ring-row views; a layout of more than `MAX_REFS` keys costs one
torch-side gather per call. The plain versions gather on the torch side
(`gather_node_refs`) into one node-major `[N, total_comp]` tensor. Every
kernel reads the model constants
and a cost-descriptor table from one packed float buffer
(`_pack_constants`), so one build serves every model with the same number
of joints: each joint count has its library (`_build.load_library(nj)`),
built at the count's first use.

Covered: every spec the Pallas kernels take (`pallas_costs._supported`).
The kinds state, control, control_grav, frame_placement, frame_translation,
frame_rotation, visual_servoing (the target `wMo · oMf_ref` composed from
the streamed `wMo_rot`/`wMo_trans:<object>` refs) and frame_velocity (the
frame's world / local / local-world-aligned velocity, a residual of q and
v) with the weighted-quad activation; collision_distance with any
activation (weighted_quad, exp, quad_exp), its per-node `w_coll` scale when
`update=True`, and the world-fixed geometry placements streamed as
`geom_rot`/`geom_trans` refs. Soft contact and the exp activations on other
kinds raise NotImplementedError, as the Pallas kernels refuse them too.

Reference parity: Crocoddyl `CostModelSum.calc/calcDiff` over the DSL cost
items (`ocp_croco_generic.py:560-592`), fused with the DAM step.
"""

from __future__ import annotations

import ctypes
import math
from types import SimpleNamespace
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models.model import ModelParams, RobotModel
from ..ocp.spec import CostItem, ProblemSpec
from . import _build
from .analytic_derivs import gravity_torque_with_dq
from .batched_costs import (
    _capsule_distance_c,
    _fk_world,
    _frame_pose_c,
    _frame_velocity_c,
    _geom_placement_c,
    _log3_c,
    _log6_c,
)
from .batched_dynamics import _StaticModel, _add, _matmul, _matvec, _sub
from .cuda_dynamics import (
    _JSTRIDE,
    _check_input,
    _pack_model,
    _ptr,
    check_smem,
    dt_per_node,
    dynamics_terms,
    launch_error,
    smem_bytes,
)

# in the order of the kernels' kind codes (`K_*`, `csrc/stage_kernels.cuh`)
COVERED_KINDS = ("state", "control", "control_grav", "frame_placement",
                 "frame_translation", "frame_rotation", "collision_distance",
                 "visual_servoing", "frame_velocity")
_FRAME_KINDS = ("frame_placement", "frame_translation", "frame_rotation",
                "visual_servoing", "frame_velocity")
_POSE_KINDS = ("frame_placement", "frame_translation", "frame_rotation",
               "visual_servoing")
ACTIVATIONS = ("weighted_quad", "exp", "quad_exp")

# cost-descriptor layout after the packed model constants (`_pack_model`);
# must match `csrc/stage_kernels.cuh` (I_* and `Desc<NJ>`)
_I_KIND, _I_WEIGHT, _I_PJOINT, _I_FROT, _I_FTRANS = 0, 1, 2, 3, 12
_I_REF, _I_W, _I_TRANS, _I_SREF = 15, 16, 17, 18
# per collision geometry (two per item): parent joint, rot 9, trans 3,
# radius, half length, then the ref-row offsets of its streamed rot/trans
_GSTRIDE = 17


def desc_layout(nj: int) -> SimpleNamespace:
    """The descriptor's slots after its static reference and weights,
    whose blocks hold the widest static item of nj joints (a state item's
    2 nj entries, at least 14: 84 floats a descriptor up to 7 joints).
    Items without geometry reuse the geometry slots: a visual-servoing item
    holds the ref-row offsets of its `wMo` rot/trans (wmo_rot, wmo_trans), a
    frame-velocity item its convention code (vel_frame)."""
    ns = max(14, 2 * nj)
    act = _I_SREF + 2 * ns
    geom = act + 3
    return SimpleNamespace(ns=ns, sw=_I_SREF + ns, act=act, alpha=act + 1,
                           wcoll=act + 2, geom=geom, wmo_rot=geom,
                           wmo_trans=geom + 1, vel_frame=geom + 2,
                           stride=geom + 2 * _GSTRIDE + 1)


_KIND_CODE = {k: i for i, k in enumerate(COVERED_KINDS)}
_ACT_CODE = {a: i for i, a in enumerate(ACTIVATIONS)}


def _vel_frame_code(reference_frame: str) -> int:
    """world 0, local 1, anything else local_world_aligned 2 (the rule of
    `_frame_velocity_c` and the Pallas bodies)."""
    return {"world": 0, "local": 1}.get(reference_frame, 2)


# ---------------------------------------------------------------------------
# per-node reference layout
# ---------------------------------------------------------------------------

def _ref_layout(model: RobotModel,
                items: Tuple[CostItem, ...]) -> List[Tuple[str, int, bool]]:
    """Ordered (refs_key, n_components, per_node) inputs the kernel needs."""
    nx = 2 * model.nj
    out: List[Tuple[str, int, bool]] = []
    seen = set()

    def add(key, ncomp, per_node=True):
        if key not in seen:
            seen.add(key)
            out.append((key, ncomp, per_node))

    for item in items:
        if not item.active:
            continue
        if item.update:
            if item.kind == "state":
                add("xref", nx)
                add("w_x", nx)
            elif item.kind == "control":
                add("uref", model.nv)
                add("w_u", model.nv)
            elif item.kind == "control_grav":
                add("w_u", model.nv)
            elif item.kind in _POSE_KINDS:
                add(f"ee_rot:{item.frame}", 9)
                add(f"ee_trans:{item.frame}", 3)
                add(f"w_ee:{item.frame}", 6)
            elif item.kind == "frame_velocity":
                add(f"ee_vel:{item.frame}", 6)
                add(f"w_ee_vel:{item.frame}", 6)
            elif item.kind == "collision_distance":
                add("w_coll", 1)
        elif item.kind in _POSE_KINDS:
            add(f"ee_rot:{item.frame}", 9)
            add(f"ee_trans:{item.frame}", 3)
        elif item.kind == "frame_velocity":
            add(f"ee_vel:{item.frame}", 6)
        if item.kind == "visual_servoing":
            add(f"wMo_rot:{item.object_frame}", 9, per_node=False)
            add(f"wMo_trans:{item.object_frame}", 3, per_node=False)
        if item.kind == "collision_distance":
            # runtime placement overrides of world-fixed (obstacle) geoms
            for g in model.collision_pairs[item.pair_id]:
                if model.geometries[g].parent_joint < 0:
                    add(f"__geom_rot:{g}", 9, per_node=False)
                    add(f"__geom_trans:{g}", 3, per_node=False)
    return out


def with_geom_defaults(layout, refs: Dict, params: ModelParams) -> Dict:
    """World-fixed geometry columns fall back to the model's placements when
    the caller streams no `geom_rot`/`geom_trans` refs."""
    if not any(k.startswith("__geom") for k, _, _ in layout):
        return refs
    refs = dict(refs)
    refs.setdefault("geom_rot", params.geom_rot)
    refs.setdefault("geom_trans", params.geom_trans)
    return refs


def gather_node_refs(layout, refs: Dict, t_idx: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Gather refs at per-node times into one node-major tensor.

    t_idx [N] int node times. Returns [N, total_comp] (at least one column),
    on t_idx's device. A `__geom_rot:{g}` / `__geom_trans:{g}` column holds
    row g of the global `geom_rot` / `geom_trans` refs; the other global
    (`per_node=False`) columns, the `wMo_*` transforms, are broadcast to
    every node."""
    N = t_idx.shape[0]
    cols = []
    for key, ncomp, per_node in layout:
        if key.startswith("__geom_"):
            src = refs.get(key[2:].split(":")[0])
            val = None if src is None else src[int(key.split(":")[1])]
        else:
            val = refs.get(key)
        if val is None:
            arr = torch.zeros((N, ncomp), dtype=dtype, device=t_idx.device)
        else:
            val = val.to(dtype=dtype, device=t_idx.device)
            if per_node and val.ndim >= 1:
                arr = val.index_select(0, t_idx).reshape(N, ncomp)
            else:
                arr = val.reshape(-1).expand(N, ncomp)
        cols.append(arr)
    if not cols:
        return torch.zeros((N, 1), dtype=dtype, device=t_idx.device)
    return torch.cat(cols, 1).contiguous()


# the kernels' source table (`ag::RefSrc`, `ag::RefTable`,
# `csrc/stage_kernels.cuh`): the layout keys it holds by value; a longer
# layout is gathered into one key (`RefPlan.table`)
MAX_REFS = 24


class RefSrc(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("stride", ctypes.c_longlong),
                ("ncomp", ctypes.c_int), ("per_node", ctypes.c_int),
                ("row", ctypes.c_int), ("off", ctypes.c_int)]


class RefTable(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int), ("e", RefSrc * MAX_REFS)]


def _rows_contiguous(t: torch.Tensor) -> bool:
    """Whether each t[i] (t itself when 0-d) lies contiguously in memory."""
    expect = 1
    for size, stride in zip(reversed(t.shape[1:]), reversed(t.stride()[1:])):
        if size != 1 and stride != expect:
            return False
        expect *= size
    return True


class RefPlan:
    """The kernels' source table for one ref layout, its keys parsed once.

    `table(refs, device)` returns (RefTable, the tensors it points into).
    Node time t's columns [off, off + ncomp) of a key are
    src[(per_node ? t : row) * stride + i]: a per-node key (`val.ndim >= 1`)
    reads val[t], a `__geom_rot:{g}` / `__geom_trans:{g}` key row g of the
    global `geom_rot` / `geom_trans` (the model's placements from `params`
    when refs has none, as `with_geom_defaults`), another global key its
    flat values, an absent key zeros: the rows `gather_node_refs` gives. A
    tensor is read in place when it is float32 on `device` with each row
    contiguous; otherwise it costs one conversion (a dtype or device move,
    a copy for strided components). The port's own callers (the tick's
    ring views, `default_references`, chip_smoke's inputs) pay none. A
    layout of more than MAX_REFS keys is gathered on the torch side, once
    per call, into the rows of every node time (`gather_node_refs` over
    the leading size of the per-node refs, a shape: no device read) and
    handed over as one per-node key of the layout's width. The returned
    tensors must live until the launch is enqueued; after that, freeing a
    converted temporary is safe on the one stream the port uses, as the
    caching allocator reuses its memory only for work queued after the
    kernel."""

    def __init__(self, layout, params: ModelParams):
        self.layout = list(layout)
        offsets, self.width = _slice_layout(self.layout)
        self.defaults = {}  # the geometry placements refs may leave out
        # (refs key, geometry row, ncomp, row offset, per-node key, geometry)
        self.keys = []
        for key, ncomp, per_node in self.layout:
            geom = key.startswith("__geom_")
            name = key[2:].split(":")[0] if geom else key
            if geom:
                self.defaults[name] = getattr(params, name)
            self.keys.append((name, int(key.split(":")[1]) if geom else 0,
                              ncomp, offsets[key][0], per_node and not geom,
                              geom))

    def _get(self, refs, name):
        return refs[name] if name in refs else self.defaults.get(name)

    def table(self, refs: Dict, device: torch.device):
        tab = RefTable()
        if len(self.keys) > MAX_REFS:
            return self._gathered(refs, device, tab)
        tab.n = len(self.keys)
        keep = []
        for e, (name, row, ncomp, off, per_node, geom) in zip(tab.e,
                                                               self.keys):
            val = self._get(refs, name)
            e.ncomp, e.off, e.row = ncomp, off, row
            if val is None:  # zeros, as the gather
                continue
            if val.dtype != torch.float32 or val.device != device:
                val = val.to(device=device, dtype=torch.float32)
            e.per_node = int(per_node and val.ndim >= 1)
            if e.per_node or geom:
                if not _rows_contiguous(val):
                    val = val.contiguous()
                if val.ndim == 0 or math.prod(val.shape[1:]) != ncomp:
                    raise ValueError(f"ref {name!r} of shape "
                                     f"{tuple(val.shape)} does not hold "
                                     f"{ncomp} values per row")
                e.stride = val.stride(0)
            else:
                if val.numel() != ncomp:
                    raise ValueError(f"ref {name!r} of shape "
                                     f"{tuple(val.shape)} does not hold "
                                     f"{ncomp} values")
                if not val.is_contiguous():
                    val = val.contiguous()
            e.src = val.data_ptr()
            keep.append(val)
        return tab, keep

    def _gathered(self, refs, device, tab):
        """The over-cap table: one key, the rows of node times
        0 .. n_t - 1 (or one row when no ref varies per node)."""
        refs = dict(refs)
        for name, default in self.defaults.items():
            refs.setdefault(name, default)
        n_t = max((refs[name].shape[0] for name, _, _, _, per_node, _ in
                   self.keys if per_node and refs.get(name) is not None
                   and refs[name].ndim >= 1), default=0)
        rows = gather_node_refs(self.layout, refs,
                                torch.arange(max(n_t, 1), device=device),
                                torch.float32)
        tab.n = 1
        e = tab.e[0]
        e.src, e.stride, e.ncomp = rows.data_ptr(), rows.stride(0), self.width
        e.per_node, e.row, e.off = int(n_t > 0), 0, 0
        return tab, [rows]


def _slice_layout(layout):
    """key -> (offset, ncomp) into the packed ref rows."""
    out = {}
    off = 0
    for key, ncomp, _ in layout:
        out[key] = (off, ncomp)
        off += ncomp
    return out, max(off, 1)


# ---------------------------------------------------------------------------
# plain PyTorch: component-form cost items
# ---------------------------------------------------------------------------

def _static_weights(item: CostItem, nr: int) -> List[float]:
    if item.act_weights is not None:
        wv = np.asarray(item.act_weights, np.float64).reshape(-1)
        if wv.shape[0] == nr:
            return [float(w) for w in wv]
        return [float(wv[0])] * nr
    return [1.0] * nr


def _weights_c(item: CostItem, rget, nr: int):
    """Runtime activation weights as components (tensors or python floats)."""
    if item.update:
        if item.kind == "state":
            return rget("w_x")
        if item.kind in ("control", "control_grav"):
            return rget("w_u")
        if item.kind in ("frame_placement", "visual_servoing"):
            return rget(f"w_ee:{item.frame}")
        if item.kind == "frame_rotation":
            return rget(f"w_ee:{item.frame}")[:3]
        if item.kind == "frame_translation":
            return rget(f"w_ee:{item.frame}")[3:]
        if item.kind == "frame_velocity":
            return rget(f"w_ee_vel:{item.frame}")
    return _static_weights(item, nr)


def _activation_c(item: CostItem, r, w, nr):
    """(l, a_dr list, a_drr list) in components (the formulas of the Pallas
    bodies: `sqrt(rr + 1e-12)` for exp, the PSD Gauss-Newton diagonal
    `4 a r^2 / alpha^2` for quad_exp)."""
    if item.activation == "weighted_quad":
        l = 0.0
        for i in range(nr):
            l = l + 0.5 * w[i] * r[i] * r[i]
        return l, [w[i] * r[i] for i in range(nr)], list(w)
    alpha = float(item.act_alpha)
    rr = 0.0
    for i in range(nr):
        rr = rr + r[i] * r[i]
    if item.activation == "exp":
        d = torch.sqrt(rr + 1e-12)
        a = torch.exp(-d / alpha)
        scale = -a / (alpha * d)
        return (a, [scale * r[i] for i in range(nr)],
                [a / (alpha * alpha)] * nr)
    a = torch.exp(-rr / alpha)  # quad_exp
    return (a, [(-2.0 / alpha) * a * r[i] for i in range(nr)],
            [(4.0 / (alpha * alpha)) * a * r[i] * r[i] for i in range(nr)])


def _geom_pose_c(model, params, oR, op, g: int, rget):
    """World placement of geometry g, as the Pallas bodies take it: a
    world-fixed geometry from its ref columns (filled from the model by
    `with_geom_defaults`), the others through the kinematics of their
    parent joint with the model's local placement."""
    if model.geometries[g].parent_joint < 0:
        return (tuple(rget(f"__geom_rot:{g}")),
                tuple(rget(f"__geom_trans:{g}")))
    return _geom_placement_c(model, params, oR, op, g, {})


def _pose_target_c(item: CostItem, rget):
    """Target (R 9-tuple, p 3-tuple) of a pose item; the visual-servoing
    target is `wMo · oMf_ref` (Pallas `_pose_target_c`, :211-222)."""
    eR = tuple(rget(f"ee_rot:{item.frame}"))
    ep = tuple(rget(f"ee_trans:{item.frame}"))
    if item.kind != "visual_servoing":
        return eR, ep
    wR = tuple(rget(f"wMo_rot:{item.object_frame}"))
    wp = tuple(rget(f"wMo_trans:{item.object_frame}"))
    return _matmul(wR, eR), _add(_matvec(wR, ep), wp)


def _residual_c(item: CostItem, model, params, sm, q, v, rget):
    """Residual components of the frame, visual-servoing, frame-velocity and
    collision kinds; list of nr tensors."""
    oR, op = _fk_world(sm, q)
    if item.kind == "collision_distance":
        gi, gj = model.collision_pairs[item.pair_id]
        R1, p1 = _geom_pose_c(model, params, oR, op, gi, rget)
        R2, p2 = _geom_pose_c(model, params, oR, op, gj, rget)
        f = lambda t, g: float(t[g])
        return [_capsule_distance_c(
            R1, p1, f(params.geom_radius, gi), f(params.geom_halflen, gi),
            R2, p2, f(params.geom_radius, gj), f(params.geom_halflen, gj))]
    fid = model.frame_id(item.frame)
    R, p = _frame_pose_c(model, params, oR, op, fid)
    if item.kind == "frame_velocity":
        nu = _frame_velocity_c(model, sm, oR, op, v, fid,
                               item.reference_frame, R, p)
        ref = rget(f"ee_vel:{item.frame}")
        return [nu[i] - ref[i] for i in range(6)]
    refR, refp = _pose_target_c(item, rget)
    if item.kind == "frame_translation":
        return list(_sub(p, refp))
    rRT = (refR[0], refR[3], refR[6], refR[1], refR[4], refR[7],
           refR[2], refR[5], refR[8])
    dR = _matmul(rRT, R)
    if item.kind == "frame_rotation":
        return list(_log3_c(dR))
    return list(_log6_c(dR, _matvec(rRT, _sub(p, refp))))


def _accumulate(acc: Dict, key: str, idx: int, val):
    cur = acc[key][idx]
    acc[key][idx] = val if cur is None else cur + val


def _item_terms_c(item: CostItem, model, params, sm, q, v, u, rget,
                  want_derivs: bool, wgt, acc: Dict):
    """Add one weighted cost item's value (and GN derivatives) into acc.

    Derivative routes: control_grav takes the closed-form gravity Jacobian
    (`analytic_derivs.gravity_torque_with_dq`); the frame, visual-servoing
    and collision kinds take forward tangents of the residual, one per
    joint, frame_velocity one per entry of (q, v), all of an item in one
    `torch.func.jvp` vmapped over the unit tangents."""
    nj = sm.nj
    nx = 2 * nj
    zero = torch.zeros_like(q[0])

    if item.kind == "state":
        xref = rget("xref") if item.update else (
            [float(s) for s in (item.static_ref or (0.0,) * nx)])
        w = _weights_c(item, rget, nx)
        xs = q + v
        l = 0.0
        for i in range(nx):
            r = xs[i] - xref[i]
            l = l + 0.5 * w[i] * r * r
            if want_derivs:
                _accumulate(acc, "lx", i, wgt * w[i] * r)
                _accumulate(acc, "lxx", i * nx + i, wgt * w[i] + zero)
        acc["l"] = acc["l"] + wgt * l
        return
    if item.kind == "control":
        uref = rget("uref") if item.update else (
            [float(s) for s in (item.static_ref or (0.0,) * nj)])
        w = _weights_c(item, rget, nj)
        l = 0.0
        for i in range(nj):
            r = u[i] - uref[i]
            l = l + 0.5 * w[i] * r * r
            if want_derivs:
                _accumulate(acc, "lu", i, wgt * w[i] * r)
                _accumulate(acc, "luu", i * nj + i, wgt * w[i] + zero)
        acc["l"] = acc["l"] + wgt * l
        return
    if item.kind == "control_grav":
        w = _weights_c(item, rget, nj)
        gq, Dg = gravity_torque_with_dq(sm, q)
        # Jg[k][i] = d g_i / d q_k
        Jg = [[Dg[i][k] + zero for i in range(nj)] for k in range(nj)]
        l = 0.0
        wr = []
        for i in range(nj):
            r = u[i] - gq[i]
            wr.append(w[i] * r)
            l = l + 0.5 * w[i] * r * r
        acc["l"] = acc["l"] + wgt * l
        if want_derivs:
            # J_u = I, J_x = [-Jg, 0]
            for i in range(nj):
                _accumulate(acc, "lu", i, wgt * wr[i])
                _accumulate(acc, "luu", i * nj + i, wgt * w[i] + zero)
            for k in range(nj):
                s = 0.0
                for i in range(nj):
                    s = s + Jg[k][i] * wr[i]
                _accumulate(acc, "lx", k, -wgt * s)
                # lxu[k, i] = -Jg[k][i] * w_i
                for i in range(nj):
                    _accumulate(acc, "lxu", k * nj + i,
                                -wgt * Jg[k][i] * w[i])
                for k2 in range(k + 1):
                    h = 0.0
                    for i in range(nj):
                        h = h + Jg[k][i] * w[i] * Jg[k2][i]
                    _accumulate(acc, "lxx", k * nx + k2, wgt * h)
                    if k2 != k:
                        _accumulate(acc, "lxx", k2 * nx + k, wgt * h)
        return

    # frame, visual-servoing and collision kinds: residuals of q;
    # frame_velocity: of q and v (the Pallas bodies' `ndiff`, :373-390)
    nr = item.residual_dim(model)
    ndiff = nx if item.kind == "frame_velocity" else nj
    if want_derivs:
        def r_of(z):
            zl = list(z.unbind(0))
            vl = zl[nj:] if ndiff == nx else v
            return torch.stack(_residual_c(
                item, model, params, sm, zl[:nj], vl, rget))

        z = torch.stack(q + v if ndiff == nx else q)
        # the ndiff unit tangents in one vmapped pass: [ndiff, nr, N]
        eye = torch.eye(ndiff, dtype=z.dtype, device=z.device)[:, :, None]
        r_st, jac = torch.func.vmap(
            lambda e: torch.func.jvp(r_of, (z,), (e.expand_as(z),)))(eye)
        Jcols = list(jac.unbind(0))
        r = list(r_st[0].unbind(0))
    else:
        r = _residual_c(item, model, params, sm, q, v, rget)

    w = _weights_c(item, rget, nr)
    l, a_dr, a_drr = _activation_c(item, r, w, nr)
    acc["l"] = acc["l"] + wgt * l
    if not want_derivs:
        return
    for k in range(ndiff):
        s = 0.0
        for i in range(nr):
            s = s + Jcols[k][i] * a_dr[i]
        _accumulate(acc, "lx", k, wgt * s)
        for k2 in range(k + 1):
            h = 0.0
            for i in range(nr):
                h = h + Jcols[k][i] * a_drr[i] * Jcols[k2][i]
            _accumulate(acc, "lxx", k * nx + k2, wgt * h)
            if k2 != k:
                _accumulate(acc, "lxx", k2 * nx + k, wgt * h)


def _node_costs(items, model, params, sm, q, v, u, rget, derivs):
    """Sum of every item over the nodes: acc dict of component lists."""
    nj = sm.nj
    nx = 2 * nj
    acc = {"l": 0.0}
    if derivs:
        acc.update(lx=[None] * nx, lu=[None] * nj, lxx=[None] * (nx * nx),
                   lxu=[None] * (nx * nj), luu=[None] * (nj * nj))
    for item in items:
        wgt = float(item.weight)
        if item.kind == "collision_distance" and item.update:
            # streamed w_collision_avoidance scale (`trajectory.py:84-158`)
            wgt = wgt * rget("w_coll")[0]
        _item_terms_c(item, model, params, sm, q, v, u, rget, derivs, wgt,
                      acc)
    return acc


def _dense(comps, zero, N, shape):
    """Component list (None = structural zero) -> node-major [N, *shape]."""
    full = [zero if c is None else c + zero for c in comps]
    return torch.stack(full, 1).reshape((N,) + shape)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def check_supported(spec: ProblemSpec, model: RobotModel,
                    device: torch.device):
    """Raises NotImplementedError, with the reason, on what the stage
    kernels do not take: what the Pallas kernels refuse
    (`pallas_costs._supported`), a frame fixed to the root, and on the card
    a joint count and cost model whose block needs more shared memory than
    the card gives one (`cuda_dynamics.check_smem`, with the bytes). Any
    joint count has its kernels (`_build.load_library(nj)`)."""
    if spec.soft_contact is not None:
        # as the Pallas kernels (`pallas_costs.py:424-426`): soft contact
        # runs on the "xla" backend
        raise NotImplementedError(
            "soft contact: the stage kernels are rigid-body (the "
            "force-augmented step runs on the 'xla' backend)")
    for item in spec.all_costs():
        if item.kind not in COVERED_KINDS:
            raise NotImplementedError(
                f"cost kind {item.kind!r} is not covered by the stage kernels")
        # as the Pallas kernels: the exp activations only on collision items
        if item.activation != "weighted_quad" and \
                item.kind != "collision_distance":
            raise NotImplementedError(
                f"activation {item.activation!r} on a {item.kind!r} item is "
                "not covered by the stage kernels")
        if item.kind in _FRAME_KINDS and \
                model.frames[model.frame_id(item.frame)].parent_joint < 0:
            raise NotImplementedError(
                f"frame {item.frame!r} is fixed to the root")
    if device.type == "cuda":
        for items, kernels in ((spec.running_costs, ("K1", "K2")),
                               (spec.terminal_costs, ("K3", "K4"))):
            for kernel in kernels:
                check_smem(kernel, *_launch_shape(model, items))


def _launch_shape(model: RobotModel, items):
    """(nj, packed-constants length, ref-row width, item count) of a stage
    or terminal kernel over `items`, as its wrapper launches it."""
    items = tuple(i for i in items if i.active)
    _, width = _slice_layout(_ref_layout(model, items))
    consts_len = (_JSTRIDE * model.nj + 3
                  + desc_layout(model.nj).stride * len(items))
    return model.nj, consts_len, width, len(items)


def _pack_constants(model: RobotModel, params: ModelParams, items,
                    offsets) -> np.ndarray:
    """Model constants + cost-descriptor table as one float32 buffer."""
    P = {f: getattr(params, f).detach().to("cpu", torch.float64).numpy()
         for f in ModelParams._fields}
    lay = desc_layout(model.nj)
    desc = np.zeros((len(items), lay.stride))
    desc[:, _I_REF:_I_TRANS + 1] = -1.0
    desc[:, lay.wcoll] = -1.0
    off = lambda key: offsets[key][0]
    for r, item in enumerate(items):
        d = desc[r]
        d[_I_KIND] = _KIND_CODE[item.kind]
        d[_I_WEIGHT] = item.weight
        nr = item.residual_dim(model)
        if item.kind in _FRAME_KINDS:
            fid = model.frame_id(item.frame)
            d[_I_PJOINT] = model.frames[fid].parent_joint
            d[_I_FROT:_I_FROT + 9] = P["frame_rot"][fid].reshape(-1)
            d[_I_FTRANS:_I_FTRANS + 3] = P["frame_trans"][fid]
        if item.kind in _POSE_KINDS:
            d[_I_REF] = off(f"ee_rot:{item.frame}")
            d[_I_TRANS] = off(f"ee_trans:{item.frame}")
        if item.kind == "visual_servoing":
            d[lay.wmo_rot] = off(f"wMo_rot:{item.object_frame}")
            d[lay.wmo_trans] = off(f"wMo_trans:{item.object_frame}")
        if item.kind == "frame_velocity":
            d[_I_REF] = off(f"ee_vel:{item.frame}")  # read with any weights
            d[lay.vel_frame] = _vel_frame_code(item.reference_frame)
        d[lay.act] = _ACT_CODE[item.activation]
        d[lay.alpha] = item.act_alpha
        if item.kind == "collision_distance":
            if item.update:
                d[lay.wcoll] = off("w_coll")
            pair = model.collision_pairs[item.pair_id]
            for k, g in enumerate(pair):
                b = d[lay.geom + k * _GSTRIDE:lay.geom + (k + 1) * _GSTRIDE]
                pj = model.geometries[g].parent_joint
                b[0] = pj
                b[1:10] = P["geom_rot"][g].reshape(-1)
                b[10:13] = P["geom_trans"][g]
                b[13] = P["geom_radius"][g]
                b[14] = P["geom_halflen"][g]
                b[15] = off(f"__geom_rot:{g}") if pj < 0 else -1.0
                b[16] = off(f"__geom_trans:{g}") if pj < 0 else -1.0
        if item.update and item.kind != "collision_distance":
            ref_key, w_key, w_shift = {
                "state": ("xref", "w_x", 0),
                "control": ("uref", "w_u", 0),
                "control_grav": (None, "w_u", 0),
                "frame_placement": (None, f"w_ee:{item.frame}", 0),
                "frame_rotation": (None, f"w_ee:{item.frame}", 0),
                "frame_translation": (None, f"w_ee:{item.frame}", 3),
                "visual_servoing": (None, f"w_ee:{item.frame}", 0),
                "frame_velocity": (None, f"w_ee_vel:{item.frame}", 0),
            }[item.kind]
            if ref_key is not None:
                d[_I_REF] = off(ref_key)
            d[_I_W] = off(w_key) + w_shift
        else:
            d[lay.sw:lay.sw + nr] = _static_weights(item, nr)
            if item.kind in ("state", "control"):
                sref = item.static_ref or (0.0,) * nr
                d[_I_SREF:_I_SREF + nr] = [float(s) for s in sref[:nr]]
    return np.concatenate([_pack_model(model, params),
                           desc.reshape(-1)]).astype(np.float32)


class _StageBase:
    """Shared set-up of the stage and terminal wrappers."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, items, derivs: bool,
                 device: torch.device | str, running: bool):
        # the spec first: an uncovered spec raises the same on any machine
        check_supported(spec, model, torch.device(device))
        self.device = resolve_device(device)
        self.model, self.params, self.derivs = model, params, derivs
        self.nj = model.nj
        self.sm = _StaticModel(model, params)
        self.items = tuple(i for i in items if i.active)
        self.layout = _ref_layout(model, self.items)
        self.offsets, self.width = _slice_layout(self.layout)
        self.plan = RefPlan(self.layout, params)
        self.name = ("K1" if derivs else "K2") if running else (
            "K3" if derivs else "K4")
        self.smem = smem_bytes(self.name, *_launch_shape(model, self.items))
        self.launches = 0  # kernel launches (CUDA path only)
        self._consts = None
        if self.device.type == "cuda":
            self._consts = torch.as_tensor(
                _pack_constants(model, params, self.items, self.offsets),
                device=self.device)

    def _rows(self, refs, t_idx, dtype):
        """The per-node ref rows [N, width] of this wrapper's items."""
        return gather_node_refs(
            self.layout, with_geom_defaults(self.layout, refs, self.params),
            t_idx, dtype)

    def _rget(self, rows):
        def rget(key):
            off, ncomp = self.offsets[key]
            return [rows[:, off + i] for i in range(ncomp)]
        return rget

    def _lib(self, x):
        if x.device.type != "cuda":
            raise ValueError(f"no stage kernel for device {x.device}")
        if self._consts is None or x.device != self.device:
            raise ValueError(
                f"wrapper built for {self.device}, called with {x.device}")
        return _build.load_library(self.nj)


class StageKernel(_StageBase):
    """K1 (derivs=True) / K2 (derivs=False) over the RUNNING cost model.

    `__call__(x [N,nx], u [N,nj], dt, t_idx [N], refs)`, with dt a Python
    float, a 0-d tensor or an [N] tensor (broadcast, as the Pallas kernel
    does), returns (xnext, Fx, Fu, l, lx, lu, lxx, lxu, luu) or (xnext, l),
    all dt-scaled cost terms, node-major: the JAX `make_pallas_stage` run's
    shapes."""

    def __init__(self, model, params, spec, derivs, device=DEFAULT_DEVICE):
        super().__init__(model, params, spec, spec.running_costs, derivs,
                         device, running=True)

    def __call__(self, x, u, dt, t_idx, refs):
        if x.device.type == "cpu":
            return self.plain(x, u, dt, t_idx, refs)
        args, outs = self.prepare(x, u, dt, t_idx, refs)
        self.launch(args)
        return outs

    def prepare(self, x, u, dt, t_idx, refs):
        """Checks the inputs, builds the source table and allocates the
        outputs: returns (the launch's arguments, the outputs). The refs
        are read in place (see `RefPlan.table`)."""
        lib = self._lib(x)
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        dt = dt_per_node(dt, x)
        for name, t, shape in (("x", x, (N, nx)), ("u", u, (N, nj)),
                               ("dt", dt, (N,))):
            _check_input(name, t, self.device, shape)
        if t_idx.shape != (N,):
            raise ValueError(f"t_idx has shape {tuple(t_idx.shape)}, "
                             f"expected {(N,)}")
        if t_idx.dtype != torch.long or t_idx.device != self.device:
            t_idx = t_idx.to(device=self.device, dtype=torch.long)
        if not t_idx.is_contiguous():
            t_idx = t_idx.contiguous()
        tab, keep = self.plan.table(refs, self.device)
        new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
        if self.derivs:
            outs = (new(nx), new(nx, nx), new(nx, nj), new(), new(nx),
                    new(nj), new(nx, nx), new(nx, nj), new(nj, nj))
            ptrs = [_ptr(o) for o in outs]
        else:
            outs = (new(nx), new())
            ptrs = [_ptr(outs[0]), None, None, _ptr(outs[1])] + [None] * 5
        args = (lib, (nj, int(self.derivs), N, _ptr(x), _ptr(u), _ptr(dt),
                      _ptr(t_idx), ctypes.c_void_p(ctypes.addressof(tab)),
                      self.width, _ptr(self._consts), self._consts.numel(),
                      len(self.items), *ptrs,
                      ctypes.c_void_p(
                          torch.cuda.current_stream(x.device).cuda_stream)),
                (tab, keep, t_idx, x, u, dt, outs))
        return args, outs

    def launch(self, args):
        """One launch of the kernel on prepared arguments (`prepare`)."""
        lib, cargs, _ = args
        err = lib.ag_stage(*cargs)
        if err != 0:
            raise launch_error(f"{self.name} stage kernel", self.nj, err,
                               self.smem)
        self.launches += 1

    def plain(self, x, u, dt, t_idx, refs):
        """The plain-PyTorch version, on the inputs' own device."""
        return self.plain_rows(x, u, dt, self._rows(refs, t_idx, x.dtype))

    def plain_rows(self, x, u, dt, rows):
        """`plain` on the nodes' gathered ref rows [N, width] (`_rows`):
        every node is computed from its own row, so the nodes of several
        calls can be stacked into one."""
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        q = list(x[:, :nj].unbind(1))
        v = list(x[:, nj:].unbind(1))
        uc = list(u.unbind(1))
        dtt = (x.new_zeros(N) + dt).to(x.dtype)
        xnext, fx, fu = dynamics_terms(self.sm, q, v, uc, dtt, self.derivs)
        acc = _node_costs(self.items, self.model, self.params, self.sm, q, v,
                          uc, self._rget(rows), self.derivs)
        zero = torch.zeros_like(q[0])
        xn = torch.stack(xnext, 1)
        l = (acc["l"] + zero) * dtt
        if not self.derivs:
            return xn, l
        d = lambda key, shape: _dense(acc[key], zero, N, shape) * dtt.reshape(
            (N,) + (1,) * len(shape))
        return (xn, _dense(fx, zero, N, (nx, nx)), _dense(fu, zero, N, (nx, nj)),
                l, d("lx", (nx,)), d("lu", (nj,)), d("lxx", (nx, nx)),
                d("lxu", (nx, nj)), d("luu", (nj, nj)))


class TerminalKernel(_StageBase):
    """K3 (derivs=True) / K4 (derivs=False) over the TERMINAL cost model.

    `__call__(x [N,nx], refs)` returns (l, lx, lxx) or (l,): cost items at
    t = horizon with u = 0 and no dt scale, views into one allocation."""

    def __init__(self, model, params, spec, derivs, device=DEFAULT_DEVICE):
        super().__init__(model, params, spec, spec.terminal_costs, derivs,
                         device, running=False)
        self.horizon = spec.horizon

    def __call__(self, x, refs):
        if x.device.type == "cpu":
            return self.plain(x, refs)
        args, outs = self.prepare(x, refs)
        self.launch(args)
        return outs

    def prepare(self, x, refs):
        """Checks x, builds the source table and allocates the outputs:
        returns (the launch's arguments, the outputs). The refs are read in
        place (see `RefPlan.table`)."""
        lib = self._lib(x)
        N, nx = x.shape[0], 2 * self.nj
        _check_input("x", x, self.device, (N, nx))
        tab, keep = self.plan.table(refs, self.device)
        sizes = (1, nx, nx * nx) if self.derivs else (1,)
        out = torch.empty(N * sum(sizes), dtype=x.dtype, device=x.device)
        outs = tuple(o.view((N,) + shape) for o, shape in zip(
            out.split([N * s for s in sizes]), ((), (nx,), (nx, nx))))
        ptrs = [_ptr(o) for o in outs] + [None] * (3 - len(outs))
        args = (lib, (self.nj, int(self.derivs), N, _ptr(x),
                      ctypes.c_void_p(ctypes.addressof(tab)), self.horizon,
                      self.width, _ptr(self._consts), self._consts.numel(),
                      len(self.items), *ptrs,
                      ctypes.c_void_p(
                          torch.cuda.current_stream(x.device).cuda_stream)),
                (tab, keep, x, out))
        return args, outs

    def launch(self, args):
        """One launch of the kernel on prepared arguments (`prepare`)."""
        lib, cargs, _ = args
        err = lib.ag_terminal(*cargs)
        if err != 0:
            raise launch_error(f"{self.name} terminal kernel", self.nj, err,
                               self.smem)
        self.launches += 1

    def plain(self, x, refs):
        """The plain-PyTorch version, on the inputs' own device."""
        return self.plain_rows(x, self.terminal_rows(x, refs))

    def terminal_rows(self, x, refs):
        """The ref rows [N, width] of N terminal nodes (t = horizon)."""
        t_idx = torch.full((x.shape[0],), self.horizon, dtype=torch.long,
                           device=x.device)
        return self._rows(refs, t_idx, x.dtype)

    def plain_rows(self, x, rows):
        """`plain` on the nodes' gathered ref rows (`terminal_rows`)."""
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        q = list(x[:, :nj].unbind(1))
        v = list(x[:, nj:].unbind(1))
        zero = torch.zeros_like(q[0])
        acc = _node_costs(self.items, self.model, self.params, self.sm, q, v,
                          [zero] * nj, self._rget(rows), self.derivs)
        l = acc["l"] + zero
        if not self.derivs:
            return (l,)
        return l, _dense(acc["lx"], zero, N, (nx,)), _dense(
            acc["lxx"], zero, N, (nx, nx))


def make_cuda_stage(model: RobotModel, params: ModelParams, spec: ProblemSpec,
                    derivs: bool, device: torch.device | str = DEFAULT_DEVICE):
    """K1/K2 wrapper for `device`; see `StageKernel`."""
    return StageKernel(model, params, spec, derivs, device)


def make_cuda_terminal(model: RobotModel, params: ModelParams,
                       spec: ProblemSpec, derivs: bool,
                       device: torch.device | str = DEFAULT_DEVICE):
    """K3/K4 wrapper for `device`; see `TerminalKernel`."""
    return TerminalKernel(model, params, spec, derivs, device)
