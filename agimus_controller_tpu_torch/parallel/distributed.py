"""Multi-process initialisation and the global mesh, over `torch.distributed`.

Port of the JAX package's `parallel/distributed.py`:

1. every process calls :func:`initialize_distributed` once, before it
   lays out a mesh: with a coordinator configured it joins the process
   group (`torch.distributed.init_process_group` on the store of the
   ``tcp://host:port`` rendezvous at the coordinator's address, the one
   ``init_method="tcp://..."`` runs), otherwise it does nothing;
2. :func:`make_global_mesh` lays the devices of all processes, in rank
   order, out as a (``batch``, ``t``) mesh with the processes along
   ``batch``: a horizon-sharded Riccati's group of ``t_shards`` slots
   (`solver/riccati_sharded.py`) never spans two processes, so its
   gather and sum stay within one process and need no collective;
3. :func:`host_local_to_global` keeps each process's own scenarios where
   they are, as `mesh.ProcessShard`s (rows and their global offset), which
   the sharded solvers take.

The process group's backend follows the devices: NCCL where every process
owns cards no other process has, gloo on the CPU or where processes share
a card (NCCL refuses two ranks on one device). Each process reports the
UUIDs of its cards through the coordinator's store before the group is
made, so the choice is made up front; on gloo a CUDA payload goes through
the host. The group carries the sizes check of `host_local_to_global`
and the batch CSQP's all-done flag (`mesh.run_lockstep`).

Single-process use needs no configuration: with no coordinator,
:func:`initialize_distributed` returns False and the mesh helpers lay out
this process's devices.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, ProcessShard, local_devices

_initialized = False
_backend: Optional[str] = None


@dataclasses.dataclass
class DistributedConfig:
    """Explicit multi-process wiring (JAX `DistributedConfig`).

    The ``AGIMUS_*`` environment variables give a launch its configuration:

    - ``AGIMUS_COORDINATOR``   -> coordinator_address (``host:port``)
    - ``AGIMUS_NUM_PROCESSES`` -> num_processes
    - ``AGIMUS_PROCESS_ID``    -> process_id

    ``local_device_ids``: the CUDA device indices this process owns (all
    it sees by default)."""

    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None
    process_id: Optional[int] = None
    local_device_ids: Optional[Sequence[int]] = None

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        def _int(name):
            v = os.environ.get(name)
            return int(v) if v is not None else None

        return cls(
            coordinator_address=os.environ.get("AGIMUS_COORDINATOR"),
            num_processes=_int("AGIMUS_NUM_PROCESSES"),
            process_id=_int("AGIMUS_PROCESS_ID"),
        )

    def is_multiprocess(self) -> bool:
        """True for an explicit multi-process launch: a coordinator is
        configured, or a cluster scheduler's variables are present."""
        if self.coordinator_address is not None:
            return True
        return any(k in os.environ for k in (
            "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE", "PMI_SIZE"))


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def backend() -> Optional[str]:
    """The group's backend, "nccl" or "gloo" (None without a group)."""
    return _backend


_LOCAL_IDS: Optional[Sequence[int]] = None


def _local_cards():
    """This process's CUDA devices (`DistributedConfig.local_device_ids`,
    else every one it sees); [] without a card."""
    if not torch.cuda.is_available():
        return []
    if _LOCAL_IDS is not None:
        return [torch.device("cuda", i) for i in _LOCAL_IDS]
    return local_devices()


def initialize_distributed(
        config: Optional[DistributedConfig] = None) -> bool:
    """Join the process group for a multi-process launch; a no-op
    returning False for a single process. Idempotent. Raises when the
    launch gives no coordinator address or no process count or rank."""
    global _initialized, _backend, _LOCAL_IDS
    if _initialized:
        return True
    cfg = config or DistributedConfig.from_env()
    if not cfg.is_multiprocess():
        return False
    if (cfg.coordinator_address is None or cfg.num_processes is None
            or cfg.process_id is None):
        raise RuntimeError(
            "multi-process launch without a complete configuration: set "
            "AGIMUS_COORDINATOR (host:port), AGIMUS_NUM_PROCESSES and "
            "AGIMUS_PROCESS_ID (or pass a DistributedConfig); the process "
            f"group needs all three, got {cfg}")
    host, _, port = cfg.coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {cfg.coordinator_address!r} "
                         "is not host:port")
    _LOCAL_IDS = cfg.local_device_ids
    rank, world = int(cfg.process_id), int(cfg.num_processes)
    timeout = timedelta(seconds=300)
    # the rendezvous `init_method="tcp://..."` runs; its store carries
    # every process's card UUIDs first: NCCL only where no card is shared
    store, rank, world = next(dist.rendezvous(
        f"tcp://{host}:{port}", rank, world, timeout=timeout))
    store.set_timeout(timeout)
    cards = [str(torch.cuda.get_device_properties(d).uuid)
             for d in _local_cards()]
    store.set(f"agimus_cards/{rank}", ",".join(cards) or "-")
    flat = [c for r in range(world)
            for c in store.get(f"agimus_cards/{r}").decode().split(",")]
    nccl = "-" not in flat and len(set(flat)) == len(flat)
    _backend = "nccl" if nccl else "gloo"
    if nccl:
        torch.cuda.set_device(_local_cards()[0])
    dist.init_process_group(_backend, store=dist.PrefixStore("default_pg",
                                                             store),
                            world_size=world, rank=rank, timeout=timeout)
    _initialized = True
    return True


def _payload_device() -> torch.device:
    """Where a collective's tensor lives: this process's first card on
    NCCL, the host on gloo."""
    return _local_cards()[0] if _backend == "nccl" else torch.device("cpu")


def all_done(done: bool, alive: bool):
    """(every process's rows done, some process still solving): one
    all-reduce of this process's two flags (`mesh.run_lockstep`)."""
    t = torch.tensor([float(done), float(not alive)],
                     device=_payload_device())
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t[0] > 0.5), bool(t[1] < 0.5)


def global_devices():
    """Every process's devices in rank order (this process's CUDA devices
    alone without a group)."""
    mine = [str(d) for d in (_local_cards() or local_devices())]
    if process_count() == 1:
        return [torch.device(d) for d in mine]
    every = [None] * process_count()
    dist.all_gather_object(every, mine)
    return [torch.device(d) for ds in every for d in ds]


def make_global_mesh(
        t_shards: int = 1,
        batch_axis: str = "batch",
        t_axis: str = "t",
        devices: Optional[Sequence] = None) -> Mesh:
    """(batch, t) mesh over the devices of all processes, processes along
    ``batch`` (JAX `make_global_mesh`).

    ``devices``: the global device list, every process's in rank order
    (`global_devices()` by default); process p owns its p-th equal part.
    Each group of ``t_shards`` consecutive slots shares a Riccati solve and
    must lie within one process: the same three `ValueError`s as JAX guard
    it."""
    devs = list(devices if devices is not None else global_devices())
    n = len(devs)
    if n % t_shards != 0:
        raise ValueError(
            f"{n} devices not divisible by t_shards={t_shards}")
    nproc = process_count()
    per_proc = n // nproc
    if t_shards > per_proc:
        raise ValueError(
            f"t_shards={t_shards} exceeds the {per_proc} devices per "
            "process — the horizon-sharded Riccati's gather would cross "
            "processes; shard the horizon within one process only")
    if per_proc % t_shards != 0:
        raise ValueError(
            f"t_shards={t_shards} does not divide the {per_proc} devices "
            "per process — a t-group row would span two processes and the "
            "Riccati's gather would cross them")
    grid = np.empty(n, dtype=object)
    grid[:] = devs
    owners = np.arange(n) // per_proc
    return Mesh(grid.reshape(n // t_shards, t_shards), (batch_axis, t_axis),
                owners.reshape(n // t_shards, t_shards))


def host_local_to_global(mesh: Mesh, local_arrays,
                         axis_name: str = "batch"):
    """Each process's own scenarios (leading axis the local batch) as
    `ProcessShard`s of the global batch ``local * process_count``, rows
    left on this process (JAX `host_local_to_global`). Every process must
    pass the same local batch size, checked by one gather of the sizes
    per distinct size. A single process gets its arrays back as tensors
    on the mesh's first slot."""
    nproc = process_count()
    checked = set()

    def place(a):
        t = torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a)
        if nproc == 1:
            return t.to(mesh.slots(axis_name)[0][0])
        b = t.shape[0]
        if b not in checked:
            sizes = [torch.zeros(1, dtype=torch.int64,
                                 device=_payload_device())
                     for _ in range(nproc)]
            dist.all_gather(sizes, torch.tensor(
                [b], dtype=torch.int64, device=_payload_device()))
            sizes = np.asarray([int(s) for s in sizes])
            if not (sizes == sizes.flat[0]).all():
                raise ValueError(
                    f"host_local_to_global requires equal local batch "
                    f"sizes on every process; got {sizes.tolist()}")
            checked.add(b)
        mine = [d for d, p in mesh.slots(axis_name) if p == process_index()]
        return ProcessShard(t.to(mine[0]), process_index() * b, b * nproc)

    if isinstance(local_arrays, dict):
        return {k: place(v) for k, v in local_arrays.items()}
    return type(local_arrays)(place(a) for a in local_arrays)
