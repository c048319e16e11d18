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
on CUDA tensors, and runs its plain-PyTorch version (`plain`, the same math
in component form) on CPU tensors. There is no fallback from one to the
other: a CUDA tensor reaches the kernel or the wrapper raises.

Per-node references are gathered on the torch side (`gather_node_refs`) into
one node-major `[N, total_comp]` tensor; the kernel reads the model
constants and a cost-descriptor table from one packed float buffer
(`_pack_constants`), so one build serves every model with the same number of
joints.

Covered cost kinds: state, control, control_grav, frame_placement,
frame_translation, frame_rotation, all with the weighted-quad activation.
Other kinds and activations raise NotImplementedError (ROADMAP queue 2).

Reference parity: Crocoddyl `CostModelSum.calc/calcDiff` over the DSL cost
items (`ocp_croco_generic.py:560-592`), fused with the DAM step.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.model import ModelParams, RobotModel
from ..ocp.spec import CostItem, ProblemSpec
from . import _build
from .analytic_derivs import gravity_torque_with_dq
from .batched_costs import _fk_world, _frame_pose_c, _log3_c, _log6_c
from .batched_dynamics import _StaticModel, _matmul, _matvec, _sub
from .cuda_dynamics import dynamics_terms

COVERED_KINDS = ("state", "control", "control_grav", "frame_placement",
                 "frame_translation", "frame_rotation")
_FRAME_KINDS = ("frame_placement", "frame_translation", "frame_rotation")
KERNEL_NJ = (2, 7)  # joint counts the kernels are instantiated for

# packed-constants layout; must match `csrc/stage_kernels.cuh`
_JSTRIDE = 31  # rot 9, trans 3, axis 3, type, parent, mass, com 3, inertia 9, armature
_ISTRIDE = 48
_I_KIND, _I_WEIGHT, _I_PJOINT, _I_FROT, _I_FTRANS = 0, 1, 2, 3, 12
_I_REF, _I_W, _I_TRANS, _I_SREF, _I_SW = 15, 16, 17, 18, 32
_KIND_CODE = {k: i for i, k in enumerate(COVERED_KINDS)}


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
            elif item.kind in _FRAME_KINDS:
                add(f"ee_rot:{item.frame}", 9)
                add(f"ee_trans:{item.frame}", 3)
                add(f"w_ee:{item.frame}", 6)
        elif item.kind in _FRAME_KINDS:
            add(f"ee_rot:{item.frame}", 9)
            add(f"ee_trans:{item.frame}", 3)
    return out


def gather_node_refs(layout, refs: Dict, t_idx: torch.Tensor,
                     dtype: torch.dtype) -> torch.Tensor:
    """Gather refs at per-node times into one node-major tensor.

    t_idx [N] int node times. Returns [N, total_comp] (at least one column),
    on t_idx's device."""
    N = t_idx.shape[0]
    cols = []
    for key, ncomp, per_node in layout:
        val = refs.get(key)
        if val is None:
            arr = torch.zeros((N, ncomp), dtype=dtype, device=t_idx.device)
        else:
            val = val.to(dtype)
            if per_node and val.ndim >= 1:
                arr = val.index_select(0, t_idx).reshape(N, ncomp)
            else:
                arr = val.reshape(-1).expand(N, ncomp)
        cols.append(arr)
    if not cols:
        return torch.zeros((N, 1), dtype=dtype, device=t_idx.device)
    return torch.cat(cols, 1).contiguous()


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
        if item.kind == "frame_placement":
            return rget(f"w_ee:{item.frame}")
        if item.kind == "frame_rotation":
            return rget(f"w_ee:{item.frame}")[:3]
        if item.kind == "frame_translation":
            return rget(f"w_ee:{item.frame}")[3:]
    return _static_weights(item, nr)


def _activation_c(item: CostItem, r, w, nr):
    """(l, a_dr list, a_drr list) of the weighted-quad activation."""
    l = 0.0
    for i in range(nr):
        l = l + 0.5 * w[i] * r[i] * r[i]
    return l, [w[i] * r[i] for i in range(nr)], list(w)


def _residual_c(item: CostItem, model, params, sm, q, rget):
    """Residual components of the frame kinds; list of nr tensors."""
    fid = model.frame_id(item.frame)
    oR, op = _fk_world(sm, q)
    R, p = _frame_pose_c(model, params, oR, op, fid)
    refR = tuple(rget(f"ee_rot:{item.frame}"))
    refp = tuple(rget(f"ee_trans:{item.frame}"))
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
    (`analytic_derivs.gravity_torque_with_dq`); the frame kinds take forward
    tangents of the residual (`torch.func.jvp`, one per joint)."""
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

    # frame kinds: residuals of q only
    nr = item.residual_dim(model)
    if want_derivs:
        def r_of(qstack):
            return torch.stack(_residual_c(
                item, model, params, sm, list(qstack.unbind(0)), rget))

        qstack = torch.stack(q)
        Jcols = []
        for k in range(nj):
            e = torch.zeros_like(qstack)
            e[k] = 1.0
            r_st, jcol = torch.func.jvp(r_of, (qstack,), (e,))
            Jcols.append(jcol)  # [nr, N]
        r = list(r_st.unbind(0))
    else:
        r = _residual_c(item, model, params, sm, q, rget)

    w = _weights_c(item, rget, nr)
    l, a_dr, a_drr = _activation_c(item, r, w, nr)
    acc["l"] = acc["l"] + wgt * l
    if not want_derivs:
        return
    for k in range(nj):
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
        _item_terms_c(item, model, params, sm, q, v, u, rget, derivs,
                      float(item.weight), acc)
    return acc


def _dense(comps, zero, N, shape):
    """Component list (None = structural zero) -> node-major [N, *shape]."""
    full = [zero if c is None else c + zero for c in comps]
    return torch.stack(full, 1).reshape((N,) + shape)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_supported(spec: ProblemSpec, model: RobotModel,
                     device: torch.device):
    if spec.soft_contact is not None:
        raise NotImplementedError(
            "soft contact is not ported yet (ROADMAP queue 1, slice 12)")
    for item in spec.all_costs():
        if item.kind not in COVERED_KINDS:
            raise NotImplementedError(
                f"cost kind {item.kind!r} is not covered by the stage kernels "
                "yet (ROADMAP queue 2: K1-K4 coverage)")
        if item.activation != "weighted_quad":
            raise NotImplementedError(
                f"activation {item.activation!r} is not covered by the stage "
                "kernels yet (ROADMAP queue 2: K1-K4 coverage)")
        if item.kind in _FRAME_KINDS and \
                model.frames[model.frame_id(item.frame)].parent_joint < 0:
            raise NotImplementedError(
                f"frame {item.frame!r} is fixed to the root")
    if device.type == "cuda" and model.nj not in KERNEL_NJ:
        raise NotImplementedError(
            f"the stage kernels are instantiated for nj in {KERNEL_NJ}, "
            f"not {model.nj}")


def _pack_constants(model: RobotModel, params: ModelParams, items,
                    offsets) -> np.ndarray:
    """Model constants + cost-descriptor table as one float32 buffer."""
    nj = model.nj
    P = {f: getattr(params, f).detach().to("cpu", torch.float64).numpy()
         for f in ModelParams._fields}
    joints = np.zeros((nj, _JSTRIDE))
    for i in range(nj):
        joints[i, 0:9] = P["joint_rot"][i].reshape(-1)
        joints[i, 9:12] = P["joint_trans"][i]
        joints[i, 12:15] = P["axis"][i]
        joints[i, 15] = 0.0 if model.joint_types[i] == "revolute" else 1.0
        joints[i, 16] = model.parents[i]
        joints[i, 17] = P["mass"][i]
        joints[i, 18:21] = P["com"][i]
        joints[i, 21:30] = P["inertia"][i].reshape(-1)
        joints[i, 30] = P["armature"][i]
    desc = np.zeros((len(items), _ISTRIDE))
    desc[:, _I_REF:_I_TRANS + 1] = -1.0
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
            d[_I_REF] = off(f"ee_rot:{item.frame}")
            d[_I_TRANS] = off(f"ee_trans:{item.frame}")
        if item.update:
            ref_key, w_key, w_shift = {
                "state": ("xref", "w_x", 0),
                "control": ("uref", "w_u", 0),
                "control_grav": (None, "w_u", 0),
                "frame_placement": (None, f"w_ee:{item.frame}", 0),
                "frame_rotation": (None, f"w_ee:{item.frame}", 0),
                "frame_translation": (None, f"w_ee:{item.frame}", 3),
            }[item.kind]
            if ref_key is not None:
                d[_I_REF] = off(ref_key)
            d[_I_W] = off(w_key) + w_shift
        else:
            d[_I_SW:_I_SW + nr] = _static_weights(item, nr)
            if item.kind in ("state", "control"):
                sref = item.static_ref or (0.0,) * nr
                d[_I_SREF:_I_SREF + nr] = [float(s) for s in sref[:nr]]
    return np.concatenate([joints.reshape(-1), P["gravity"],
                           desc.reshape(-1)]).astype(np.float32)


def _check_input(name, t, device, shape):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the kernel on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


class _StageBase:
    """Shared set-up of the stage and terminal wrappers."""

    def __init__(self, model: RobotModel, params: ModelParams,
                 spec: ProblemSpec, items, derivs: bool,
                 device: torch.device | str):
        self.device = torch.device(device)
        _check_supported(spec, model, self.device)
        self.model, self.params, self.derivs = model, params, derivs
        self.nj = model.nj
        self.sm = _StaticModel(model, params)
        self.items = tuple(i for i in items if i.active)
        self.layout = _ref_layout(model, self.items)
        self.offsets, self.width = _slice_layout(self.layout)
        self.launches = 0  # kernel launches (CUDA path only)
        self._consts = None
        if self.device.type == "cuda":
            self._consts = torch.as_tensor(
                _pack_constants(model, params, self.items, self.offsets),
                device=self.device)

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
        return _build.load_library()


class StageKernel(_StageBase):
    """K1 (derivs=True) / K2 (derivs=False) over the RUNNING cost model.

    `__call__(x [N,nx], u [N,nj], dt [N], t_idx [N], refs)` returns
    (xnext, Fx, Fu, l, lx, lu, lxx, lxu, luu) or (xnext, l), all dt-scaled
    cost terms, node-major: the JAX `make_pallas_stage` run's shapes."""

    def __init__(self, model, params, spec, derivs, device="cpu"):
        super().__init__(model, params, spec, spec.running_costs, derivs,
                         device)

    def __call__(self, x, u, dt, t_idx, refs):
        if x.device.type == "cpu":
            return self.plain(x, u, dt, t_idx, refs)
        lib = self._lib(x)
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        rows = gather_node_refs(self.layout, refs, t_idx, x.dtype)
        for name, t, shape in (("x", x, (N, nx)), ("u", u, (N, nj)),
                               ("dt", dt, (N,)), ("refs rows", rows,
                                                  (N, self.width))):
            _check_input(name, t, self.device, shape)
        new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
        if self.derivs:
            outs = (new(nx), new(nx, nx), new(nx, nj), new(), new(nx),
                    new(nj), new(nx, nx), new(nx, nj), new(nj, nj))
            ptrs = [_ptr(o) for o in outs]
        else:
            outs = (new(nx), new())
            ptrs = [_ptr(outs[0]), None, None, _ptr(outs[1])] + [None] * 5
        err = lib.ag_stage(
            nj, int(self.derivs), N, _ptr(x), _ptr(u), _ptr(dt), _ptr(rows),
            self.width, _ptr(self._consts), self._consts.numel(),
            len(self.items), *ptrs,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"stage kernel launch failed: {_build.error_string(err)}")
        self.launches += 1
        return outs

    def plain(self, x, u, dt, t_idx, refs):
        """The plain-PyTorch version, on the inputs' own device."""
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        rows = gather_node_refs(self.layout, refs, t_idx, x.dtype)
        q = list(x[:, :nj].unbind(1))
        v = list(x[:, nj:].unbind(1))
        uc = list(u.unbind(1))
        dtt = dt.to(x.dtype)
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
    t = horizon with u = 0 and no dt scale."""

    def __init__(self, model, params, spec, derivs, device="cpu"):
        super().__init__(model, params, spec, spec.terminal_costs, derivs,
                         device)
        self.horizon = spec.horizon

    def _t_idx(self, x):
        return torch.full((x.shape[0],), self.horizon, dtype=torch.long,
                          device=x.device)

    def __call__(self, x, refs):
        if x.device.type == "cpu":
            return self.plain(x, refs)
        lib = self._lib(x)
        N, nx = x.shape[0], 2 * self.nj
        rows = gather_node_refs(self.layout, refs, self._t_idx(x), x.dtype)
        _check_input("x", x, self.device, (N, nx))
        _check_input("refs rows", rows, self.device, (N, self.width))
        new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
        outs = (new(), new(nx), new(nx, nx)) if self.derivs else (new(),)
        ptrs = [_ptr(o) for o in outs] + [None] * (3 - len(outs))
        err = lib.ag_terminal(
            self.nj, int(self.derivs), N, _ptr(x), _ptr(rows), self.width,
            _ptr(self._consts), self._consts.numel(), len(self.items), *ptrs,
            ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
        if err != 0:
            raise RuntimeError(f"terminal kernel launch failed: {_build.error_string(err)}")
        self.launches += 1
        return outs

    def plain(self, x, refs):
        """The plain-PyTorch version, on the inputs' own device."""
        N, nj = x.shape[0], self.nj
        nx = 2 * nj
        rows = gather_node_refs(self.layout, refs, self._t_idx(x), x.dtype)
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
                    derivs: bool, device: torch.device | str = "cpu"):
    """K1/K2 wrapper for `device`; see `StageKernel`."""
    return StageKernel(model, params, spec, derivs, device)


def make_cuda_terminal(model: RobotModel, params: ModelParams,
                       spec: ProblemSpec, derivs: bool,
                       device: torch.device | str = "cpu"):
    """K3/K4 wrapper for `device`; see `TerminalKernel`."""
    return TerminalKernel(model, params, spec, derivs, device)
