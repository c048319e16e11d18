"""Horizon-sharded Riccati: the T axis over the slots of a mesh axis.

Port of the JAX package's `solver/riccati_sharded.py`. `riccati_pscan.
parallel_riccati` runs the backward sweep as one log-depth scan on one
device; here the horizon itself is cut into n blocks of Tb = T / n stages,
one per slot of the mesh axis. The two-level scheme is exact:

1. **Within a block**: each slot builds its stage elements and runs the
   reverse scan of `riccati_pscan` on its block, on its device: S_t, the
   composition of local stages t..Tb-1; its block composite is S_0.
2. **Across blocks**: the n block composites are gathered, and the
   cross-block suffix recursion runs replicated (n is small): it gives
   each block the element at its right edge, E_right (the blocks after
   it and the terminal element).
3. **Local recovery**: every local node's value function is
   `combine(E_right, S_t)`, the gains come from the one-shot pass
   (`riccati_pscan._gains_at`), and d1 and d2 are summed over the blocks.

`parallel.distributed.make_global_mesh` refuses any t-group that spans two
processes, so the sweep never needs a process-group collective: its
"all_gather" is a stack of the slots' composites moved to each slot's
device, where the replicated recursion runs once per distinct device,
and its "psum" is a sum on the first slot's device.

`solve_fddp_tsharded` is `fddp.solve_fddp` with the per-node derivatives
and the Riccati sweep sharded so; the gaps and the line search run on the
first slot's device, over the gathered blocks.
"""

from __future__ import annotations

import torch

from .fddp import (
    Solution,
    SolverSettings,
    _forward,
    _gaps,
    feasibility_gate,
    total_cost,
)
from .riccati_pscan import (
    _Elem,
    _combine,
    _gains_at,
    _reverse_scan,
    _stage_elements,
    _terminal_element,
)


def _slots(mesh, axis_name):
    return [d for d, _ in mesh.slots(axis_name)]


def make_tsharded_riccati(mesh, axis_name: str = "t"):
    """Build `riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs_next, term_lx,
    term_lxx, reg) -> (ks, Ks, Qus, Vx, Vxx, d1, d2)` (JAX
    `make_tsharded_riccati`): one scenario, every [T, ...] input cut into
    blocks over the ``axis_name`` slots of ``mesh``, fs_next [T, nx] the
    gaps of nodes 1..T, reg a number or 0-d tensor. The [T, ...] outputs
    (Vx, Vxx at nodes 0..T-1) come back in order on the first slot's
    device. T must divide by the slot count."""
    slots = _slots(mesh, axis_name)
    n = len(slots)

    def riccati(lx, lu, lxx, lxu, luu, Fx, Fu, fs_next, term_lx, term_lxx,
                reg):
        T = lx.shape[0]
        if T % n:
            raise ValueError(f"T={T} must divide over {n} slots")
        Tb = T // n
        stage = (lx, lu, lxx, lxu, luu, Fx, Fu, fs_next)
        # [Tb, 1, ...] blocks (the scenario axis of `riccati_pscan`)
        blocks, S, comp = [], [], []
        for d, dev in enumerate(slots):
            blk = tuple(a[d * Tb:(d + 1) * Tb, None].to(dev) for a in stage)
            r = torch.as_tensor(reg, dtype=lx.dtype, device=dev).reshape(1)
            Sd = _reverse_scan(_stage_elements(*blk, r))
            blocks.append((blk, r))
            S.append(Sd)
            comp.append(_Elem(*(a[0] for a in Sd)))  # the block composite
        # the gather and the replicated cross-block recursion, once per
        # distinct device: rights[d] composes blocks d+1.. and the terminal
        rights_on = {}
        for dev in dict.fromkeys(slots):
            allB = [_Elem(*(a.to(dev) for a in c)) for c in comp]
            R = _terminal_element(term_lx[None].to(dev),
                                  term_lxx[None].to(dev))
            rights = [None] * n
            for d in reversed(range(n)):
                rights[d] = R
                R = _combine(R, allB[d])
            rights_on[dev] = rights
        out, d1, d2 = [], 0.0, 0.0
        first = slots[0]
        for d, dev in enumerate(slots):
            (blk, r), E = blocks[d], rights_on[dev][d]
            full = _combine(E, S[d])
            Vx_loc, Vxx_loc = -full.eta, full.J  # [Tb, 1, ...]
            Vx_next = torch.cat([Vx_loc[1:], -E.eta[None]], 0)
            Vxx_next = torch.cat([Vxx_loc[1:], E.J[None]], 0)
            ks, Ks, Qus, d1_t, d2_t = _gains_at(*blk, Vx_next, Vxx_next, r)
            out.append(tuple(a[:, 0].to(first)
                             for a in (ks, Ks, Qus, Vx_loc, Vxx_loc)))
            d1 = d1 + d1_t.sum().to(first)
            d2 = d2 + d2_t.sum().to(first)
        ks, Ks, Qus, Vx, Vxx = (torch.cat(parts, 0) for parts in zip(*out))
        return ks, Ks, Qus, Vx, Vxx, d1, d2

    return riccati


def solve_fddp_tsharded(cf, x0, refs, xs_init, us_init,
                        settings: SolverSettings, mesh,
                        axis_name: str = "t") -> Solution:
    """Single-scenario FDDP with the horizon sharded over the mesh (JAX
    `solve_fddp_tsharded`): each slot evaluates the stage derivatives of
    its block on its device (``cf`` replicated there) and the Riccati sweep
    is `make_tsharded_riccati`'s; the gaps and the line-search rollouts run
    on the first slot's device. Semantics of `fddp.solve_fddp`, with one
    deliberate difference from the JAX function: the filter's feasibility
    gate is `fddp.feasibility_gate(dtype)` (JAX: a fixed 1e-9), which is
    1e-9 in float64, so every float64 result is JAX's."""
    from ..parallel.mesh import cost_functions_on

    slots = _slots(mesh, axis_name)
    n = len(slots)
    T = us_init.shape[0]
    if T % n:
        raise ValueError(f"T={T} must divide over {n} slots")
    Tb = T // n
    first = slots[0]
    s = settings
    kw = dict(dtype=xs_init.dtype, device=first)
    cfs = {dev: cost_functions_on(cf, dev) for dev in dict.fromkeys(slots)}
    refs_at = {dev: {k: v.to(dev) for k, v in refs.items()} for dev in cfs}
    cf0, refs0 = cfs[first], refs_at[first]
    x0 = x0.to(first)
    sdiff = getattr(cf, "state_diff", None)
    alphas = torch.as_tensor([0.5 ** i for i in range(s.n_alphas)], **kw)
    riccati = make_tsharded_riccati(mesh, axis_name)

    def derivs_of(xs, us):
        parts = []
        for d, dev in enumerate(slots):
            rows = slice(d * Tb, (d + 1) * Tb)
            ts = torch.arange(d * Tb, (d + 1) * Tb, device=dev)
            parts.append(cfs[dev].stage_derivs_b(
                xs[rows].to(dev), us[rows].to(dev), ts, refs_at[dev]))
        d = type(parts[0])(*(torch.cat([p[i].to(first) for p in parts], 0)
                             for i in range(len(parts[0]))))
        return d, cf0.terminal_derivs(xs[-1], refs0)

    def sweep(d, term, fs, reg):
        return riccati(d.lx, d.lu, d.lxx, d.lxu, d.luu, d.Fx, d.Fu, fs[1:],
                       term.lx, term.lxx, reg)

    xs, us = xs_init.to(first), us_init.to(first)
    cost = total_cost(cf0, xs, us, refs0)
    reg = torch.as_tensor(s.reg_init, **kw)
    converged = torch.zeros((), dtype=torch.bool, device=first)
    iters = 0
    for _ in range(s.max_iters):
        if bool(converged):
            break  # the JAX scan's remaining iterations are no-ops
        d, term = derivs_of(xs, us)
        fs = _gaps(x0, xs, d.xnext, sdiff)
        gap_norm = fs.abs().max()
        ks_new, Ks_new, Qus, _, _, _, _ = sweep(d, term, fs, reg)
        diverged = ~(torch.isfinite(ks_new).all()
                     & torch.isfinite(Ks_new).all())
        kkt_new = torch.maximum(Qus.abs().max(), gap_norm)
        xs_a, us_a, cost_a = _forward(cf0, x0, xs, us, ks_new, Ks_new, fs,
                                      alphas, refs0)
        finite = torch.isfinite(cost_a) & torch.isfinite(
            xs_a.reshape(s.n_alphas, -1)).all(-1)
        reduction = cost - cost_a
        gaps_a = (1.0 - alphas) * gap_norm
        infeasible = gap_norm > feasibility_gate(gap_norm.dtype)
        accept = finite & ((reduction > 0.0) | (
            infeasible & (gaps_a < gap_norm * (1.0 - 1e-6))))
        best = accept.to(torch.int32).argmax()
        step_ok = accept.any() & ~diverged
        xs = torch.where(step_ok, xs_a[best], xs)
        us = torch.where(step_ok, us_a[best], us)
        cost = torch.where(step_ok, cost_a[best], cost)
        reg = torch.clamp(torch.where(step_ok, reg / s.reg_dec,
                                      reg * s.reg_inc), s.reg_min, s.reg_max)
        iters += 1
        converged = kkt_new < s.termination_tolerance

    d, term = derivs_of(xs, us)
    fs = _gaps(x0, xs, d.xnext, sdiff)
    ks_f, Ks_f, Qus, _, _, _, _ = sweep(
        d, term, fs, torch.as_tensor(s.reg_min, **kw))
    gap_norm = fs.abs().max()
    return Solution(
        xs=xs, us=us, K=Ks_f, k=ks_f, cost=cost,
        kkt=torch.maximum(Qus.abs().max(), gap_norm), gap_norm=gap_norm,
        iters=torch.as_tensor(iters, device=first), reg=reg,
        converged=converged)
