"""Device meshes and sharded batch solving.

Port of the JAX package's `parallel/mesh.py`. Scenarios are data-parallel
over the mesh's ``batch`` axis: a sharded solver splits the batch into
equal shards, one per slot of that axis, solves each shard on its slot's
device and returns the rows in global order on the first slot's device.

`Mesh` is the port's counterpart of `jax.sharding.Mesh`: a numpy grid of
`torch.device` with named axes, and beside it the process that owns each
slot. A grid may name one device in several slots: that is how the CPU
tests run eight shards (the JAX tests' eight virtual CPU devices) and how
one card runs several. A slot on a CUDA device always solves there; a
mesh names CUDA devices only where the card exists.

One solver is built per distinct device, with the model's parameters and
the refs replicated there. Where JAX runs a `vmap` of the solve under a
sharding constraint, the port runs the shards one after the other (slots
of one device share its stream). The JAX loops exit on batch-wide
reductions, which stay global under sharding. Every row of the batch SQP
and the batch FDDP is frozen exactly once it is done (its iterations and
flags are its own), so those shards need not agree on when to stop. The
batch CSQP's ADMM count is the loop's, shared by every row of the batch
(`solver/csqp_batch.py`): its shards run in lockstep and decide each ADMM
exit together, within the process and, through `parallel/distributed.py`,
across processes. No shard stops on its own there.

In a multi-process run (`parallel/distributed.py`) each process owns the
slots of its devices and solves only its own rows: a sharded solver takes
the `ProcessShard`s of `host_local_to_global` and returns `ProcessShard`s.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..solver.fddp import Solution, SolverSettings, solve_fddp


def _device(d) -> torch.device:
    """`d` as a `torch.device`, a CUDA device with its index."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes (`jax.sharding.Mesh`).

    ``devices``: nested sequences or a numpy array of devices (or their
    names), one axis per name in ``axis_names``. ``process_ids``: the
    process owning each slot, the grid's shape (all 0 by default)."""

    def __init__(self, devices, axis_names: Sequence[str],
                 process_ids=None):
        arr = np.asarray(devices, dtype=object)
        grid = np.empty(arr.shape, dtype=object)
        for idx, d in np.ndenumerate(arr):
            grid[idx] = _device(d)
        self.axis_names = tuple(axis_names)
        if grid.ndim != len(self.axis_names):
            raise ValueError(f"a {grid.ndim}-d device grid for axes "
                             f"{self.axis_names}")
        self.devices = grid
        self.process_ids = (np.zeros(grid.shape, dtype=int)
                            if process_ids is None
                            else np.asarray(process_ids, dtype=int))
        if self.process_ids.shape != grid.shape:
            raise ValueError("process_ids must have the grid's shape")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    def slots(self, axis_name: str):
        """[(device, process)] along ``axis_name``, the other axes at their
        first index (the data is replicated along them)."""
        ax = self.axis_names.index(axis_name)
        take = lambda g: np.moveaxis(g, ax, 0).reshape(
            self.devices.shape[ax], -1)[:, 0]
        return list(zip(take(self.devices), take(self.process_ids).tolist()))


def local_devices() -> List[torch.device]:
    """This process's CUDA devices, in index order; raises without a card
    (a CPU mesh names its devices: ``devices=["cpu"] * n``)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass devices= "
                           "(e.g. ['cpu'] * 8) to lay a mesh out on the host")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "batch",
              devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over the first ``n_devices`` of ``devices`` (this
    process's CUDA devices by default)."""
    devs = local_devices() if devices is None else list(devices)
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"{n} slots asked of {len(devs)} devices")
    return Mesh(np.asarray(devs[:n], dtype=object).reshape(n), (axis_name,))


class ProcessShard(NamedTuple):
    """A process's own rows of a global batch: ``data`` holds global rows
    ``start`` to ``start + len(data)`` of ``global_size``
    (`distributed.host_local_to_global`; the sharded solvers return their
    results so in a multi-process run)."""

    data: torch.Tensor
    start: int
    global_size: int


def shard_batch(mesh: Mesh, arrays, axis_name: str = "batch"):
    """Place arrays (tensors or numpy, a tuple or a dict of them) on the
    mesh's first slot, checked to split evenly over the ``axis_name`` slots;
    a sharded solver splits them over the slots as it solves."""
    n = len(mesh.slots(axis_name))
    first = mesh.slots(axis_name)[0][0]

    def place(a):
        t = torch.as_tensor(a, device=first)
        if t.shape[0] % n:
            raise ValueError(f"batch {t.shape[0]} does not split over {n} "
                             f"slots")
        return t

    if isinstance(arrays, dict):
        return {k: place(v) for k, v in arrays.items()}
    return type(arrays)(place(a) for a in arrays)


def params_on(params, device: torch.device):
    """`ModelParams` on ``device``."""
    return type(params)(*(t.to(device) for t in params))


def cost_functions_on(cf, device: torch.device):
    """``cf`` with its parameters on ``device`` (the same object where they
    already are there): `CostFunctions` and `FFCostFunctions` are rebuilt
    from their model, spec and dtype."""
    from ..ocp.costs import CostFunctions
    from ..ocp.ff_costs import FFCostFunctions

    if cf is None or cf.params.joint_rot.device == device:
        return cf
    params, dtype = params_on(cf.params, device), cf._timesteps.dtype
    if type(cf) is CostFunctions:
        return CostFunctions(cf.model, params, cf.spec, dtype)
    if type(cf) is FFCostFunctions:
        return FFCostFunctions(cf.model, params, cf.spec, dtype,
                               "floating_base" if cf.under else "full")
    raise TypeError(f"cannot replicate {type(cf).__name__} to {device}")


def _refs_on(refs: Dict, device: torch.device) -> Dict:
    return {k: v.to(device) for k, v in refs.items()}


def _concat(parts, device: torch.device):
    """One result of the shards' results (same NamedTuple type), rows in
    order on ``device``: tensors concatenated, counts summed, None kept."""
    first = parts[0]
    out = []
    for i, v in enumerate(first):
        if isinstance(v, torch.Tensor):
            out.append(torch.cat([p[i].to(device) for p in parts], 0))
        elif v is None:
            out.append(None)
        else:
            out.append(sum(p[i] for p in parts))
    return type(first)(*out)


def run_lockstep(gens: List, reduce: Optional[Callable] = None) -> List:
    """Drive generators that yield their rows' done flags ([B] bool) at each
    batch-wide loop exit and take back whether every row of the whole batch
    is done; returns their results. A finished generator counts as done.
    ``reduce(done, alive) -> (done, alive)`` combines the flags across
    processes; every process then runs the same rounds."""
    results = [None] * len(gens)
    flags: Dict[int, torch.Tensor] = {}

    def advance(i, decision):
        try:
            flags[i] = (next(gens[i]) if decision is None
                        else gens[i].send(decision))
        except StopIteration as stop:
            results[i] = stop.value
            flags.pop(i, None)

    for i in range(len(gens)):
        advance(i, None)
    while True:
        done = all(bool(f.all()) for f in flags.values())
        alive = bool(flags)
        if reduce is not None:
            done, alive = reduce(done, alive)
        if not alive:
            return results
        for i in list(flags):
            advance(i, done)


class _ShardedSolver:
    """Split the batch over the ``axis_name`` slots this process owns, solve
    each shard on its slot's device with the solver ``build(device)`` made
    once per device, return the rows in order on the first slot's device.
    ``lockstep``: the solvers have `steps(...)` generators whose loop exits
    the shards decide together (`run_lockstep`)."""

    def __init__(self, mesh: Mesh, axis_name: str, build: Callable,
                 lockstep: bool = False):
        from .distributed import process_index

        self.slots = mesh.slots(axis_name)
        rank = process_index()
        self.local = [d for d, p in self.slots if p == rank]
        self.spans_processes = len({p for _, p in self.slots}) > 1
        self.build, self.lockstep = build, lockstep
        self.solvers: Dict[torch.device, object] = {}

    def solver(self, device: torch.device):
        if device not in self.solvers:
            self.solvers[device] = self.build(device)
        return self.solvers[device]

    def __call__(self, x0s, refs, xs0, us0, **kw):
        shard = isinstance(x0s, ProcessShard)
        if shard:
            start, size = x0s.start, x0s.global_size
            x0s, xs0, us0 = x0s.data, xs0.data, us0.data
        elif self.spans_processes:
            raise ValueError("a mesh over several processes takes the "
                             "ProcessShards of host_local_to_global")
        n = len(self.local)
        B = x0s.shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} slots")
        b = B // n
        refs_at, calls = {}, []
        for i, dev in enumerate(self.local):
            if dev not in refs_at:
                refs_at[dev] = _refs_on(refs, dev)
            rows = slice(i * b, (i + 1) * b)
            calls.append((self.solver(dev), (
                x0s[rows].to(dev), refs_at[dev], xs0[rows].to(dev),
                us0[rows].to(dev))))
        if self.lockstep:
            reduce = None
            if self.spans_processes:
                from .distributed import all_done

                reduce = all_done
            parts = run_lockstep([s.steps(*a, **kw) for s, a in calls],
                                 reduce)
        else:
            parts = [s(*a, **kw) for s, a in calls]
        out = _concat(parts, self.local[0])
        if not shard:
            return out
        return type(out)(*(ProcessShard(v, start, size)
                           if isinstance(v, torch.Tensor) else v
                           for v in out))


def make_batch_solver(cf, settings: SolverSettings = SolverSettings()):
    """The multi-scenario `solve_fddp` (JAX: its `vmap`): ``solve(x0s
    [B,nx], refs, xs [B,T+1,nx], us [B,T,nu]) -> Solution`` with a leading
    [B], each row the single-scenario solve of its inputs (refs shared)."""

    def solve(x0s, refs, xs0, us0) -> Solution:
        rows = [solve_fddp(cf, x0s[i], refs, xs0[i], us0[i], settings)
                for i in range(x0s.shape[0])]
        return Solution(*(torch.stack([r[f] for r in rows])
                          for f in range(len(Solution._fields) - 1)),
                        host_syncs=sum(r.host_syncs for r in rows))

    return solve


def batch_solve(cf, settings, x0s, refs, xs0, us0) -> Solution:
    return make_batch_solver(cf, settings)(x0s, refs, xs0, us0)


def sharded_batch_solver(cf, settings: SolverSettings, mesh: Mesh,
                         axis_name: str = "batch"):
    """`make_batch_solver` with the scenarios sharded over the mesh, ``cf``
    replicated to each slot's device."""
    return _ShardedSolver(mesh, axis_name, lambda dev: make_batch_solver(
        cost_functions_on(cf, dev), settings))


def _manifold(cf):
    return getattr(cf, "ntan", None) is not None


def sharded_batch_csqp(model, params, spec, cf, settings, mesh: Mesh,
                       axis_name: str = "batch"):
    """The batch-native constrained CSQP (`solver/csqp_batch.py`) sharded
    over the mesh; the shards decide each ADMM exit together (the JAX
    solver's all-done reduction)."""
    from ..solver.csqp_batch import make_batch_csqp

    return _ShardedSolver(mesh, axis_name, lambda dev: make_batch_csqp(
        model, params_on(params, dev), spec, cost_functions_on(cf, dev),
        settings, device=dev), lockstep=True)


def sharded_batch_sqp(model, params, spec, cf, settings, mesh: Mesh,
                      axis_name: str = "batch", backend: str = "auto"):
    """The latency solver (`solver/sqp_batch.py`) sharded over the mesh;
    ``cf`` matters only with a Lie-group state (the "manifold" backend)."""
    from ..solver.sqp_batch import make_batch_sqp

    return _ShardedSolver(mesh, axis_name, lambda dev: make_batch_sqp(
        model, params_on(params, dev), spec, settings, device=dev,
        backend=backend,
        cf=cost_functions_on(cf, dev) if _manifold(cf) else None))


def sharded_batch_fddp(model, params, spec, cf, settings, mesh: Mesh,
                       axis_name: str = "batch", riccati: str = "component"):
    """The batch-native FDDP (`solver/fddp_batch.py`) sharded over the mesh;
    ``riccati="pscan"`` takes the horizon-parallel sweep. ``cf`` matters
    only with a Lie-group state."""
    from ..solver.fddp_batch import make_batch_fddp

    return _ShardedSolver(mesh, axis_name, lambda dev: make_batch_fddp(
        model, params_on(params, dev), spec, settings, riccati=riccati,
        device=dev, cf=cost_functions_on(cf, dev) if _manifold(cf) else None))
