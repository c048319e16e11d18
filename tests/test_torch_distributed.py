"""The multi-process runtime of the port (`parallel/distributed.py`).

The configuration from the `AGIMUS_*` environment and scheduler
detection, the single-process no-op, the global mesh's layout and its
three refusals, the `host_local_to_global` round trip (JAX
`tests/test_distributed.py`'s cases), and two real OS processes joined
through the environment path on the CPU (gloo): each process's rows equal
the single-process solve (JAX `test_two_process_sharded_solve`). The
worker, `tests/_torch_distributed_worker.py`, imports no JAX.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import chip_smoke
from agimus_controller_tpu_torch.parallel import (
    DistributedConfig,
    host_local_to_global,
    initialize_distributed,
    make_global_mesh,
)
from agimus_controller_tpu_torch.parallel import distributed
from agimus_controller_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parent.parent
SCHEDULERS = ("AGIMUS_COORDINATOR", "SLURM_JOB_ID", "OMPI_COMM_WORLD_SIZE",
              "PMI_SIZE")
CPUS = [torch.device("cpu", i) for i in range(8)]  # labelled CPU slots


def test_single_process_is_noop(monkeypatch):
    for k in SCHEDULERS:
        monkeypatch.delenv(k, raising=False)
    assert initialize_distributed() is False
    assert not dist.is_initialized()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0
    assert distributed.backend() is None


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("AGIMUS_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("AGIMUS_NUM_PROCESSES", "4")
    monkeypatch.setenv("AGIMUS_PROCESS_ID", "2")
    cfg = DistributedConfig.from_env()
    assert cfg.coordinator_address == "10.0.0.1:1234"
    assert cfg.num_processes == 4
    assert cfg.process_id == 2
    assert cfg.is_multiprocess()


def test_scheduler_autodetect(monkeypatch):
    monkeypatch.delenv("AGIMUS_COORDINATOR", raising=False)
    monkeypatch.setenv("SLURM_JOB_ID", "77")
    assert DistributedConfig.from_env().is_multiprocess()


@pytest.mark.parametrize("config, error", [
    (DistributedConfig(coordinator_address="localhost:1234"), RuntimeError),
    (DistributedConfig(num_processes=2, process_id=0), RuntimeError),
    (DistributedConfig(coordinator_address="nohost", num_processes=2,
                       process_id=0), ValueError),
])
def test_incomplete_launch_raises(monkeypatch, config, error):
    """A multi-process launch the group cannot be formed from raises with a
    message naming what is missing, and joins nothing."""
    for k in SCHEDULERS:
        monkeypatch.delenv(k, raising=False)
    if config.coordinator_address is None:
        monkeypatch.setenv("SLURM_JOB_ID", "77")
    with pytest.raises(error, match="AGIMUS_COORDINATOR|host:port"):
        initialize_distributed(config)
    assert not dist.is_initialized()


def test_global_mesh_layout():
    mesh = make_global_mesh(t_shards=2, devices=CPUS)
    assert mesh.axis_names == ("batch", "t")
    assert mesh.shape == {"batch": 4, "t": 2}
    # contiguous t-groups: the slots of one t-row are adjacent
    ids = np.vectorize(lambda d: d.index)(mesh.devices)
    assert (np.diff(ids, axis=1) == 1).all()
    assert (mesh.process_ids == 0).all()


def test_global_mesh_validation(monkeypatch):
    with pytest.raises(ValueError, match="not divisible"):
        make_global_mesh(t_shards=3, devices=CPUS)  # 8 % 3 != 0
    with pytest.raises(ValueError):
        make_global_mesh(t_shards=16, devices=CPUS)
    # more than the devices per process: 2 processes x 4, t_shards=8
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="exceeds"):
        make_global_mesh(t_shards=8, devices=CPUS)


def test_global_mesh_rejects_cross_process_t_groups(monkeypatch):
    # 2 processes x 6 slots, t_shards=4: a t-row would span both
    monkeypatch.setattr(distributed, "process_count", lambda: 2)
    with pytest.raises(ValueError, match="does not divide"):
        make_global_mesh(t_shards=4, devices=CPUS + CPUS[:4])
    mesh = make_global_mesh(t_shards=2, devices=CPUS)
    assert mesh.process_ids.tolist() == [[0, 0], [0, 0], [1, 1], [1, 1]]


def test_host_local_to_global_roundtrip():
    mesh = make_global_mesh(t_shards=1, devices=["cpu"] * 8)
    a = np.arange(8 * 3, dtype=np.float64).reshape(8, 3)
    tree = {"x": a, "u": a[:, :2].copy()}
    placed = host_local_to_global(mesh, tree)
    assert isinstance(placed["x"], torch.Tensor)
    np.testing.assert_array_equal(placed["x"].numpy(), a)
    assert float(placed["x"].sum() + placed["u"].sum()) == (
        a.sum() + a[:, :2].sum())
    # a single-process batch mesh takes it as make_mesh's does
    assert mesh.slots("batch") == make_mesh(8, devices=["cpu"] * 8).slots(
        "batch")


def test_two_process_sharded_solve(tmp_path):
    """Two OS processes join one group through the `AGIMUS_*` environment
    (gloo on the CPU), each solves its own two scenarios of the tiny Panda
    problem over its two slots; each row equals the single-process solve
    of all four."""
    results = chip_smoke.launch_workers(
        ROOT / "tests" / "_torch_distributed_worker.py", tmp_path, "cpu")
    ref = chip_smoke.tiny_reference(torch.device("cpu"), torch.float64, 4)
    got = {}
    for r in results:
        assert str(r["backend"]) == "gloo"
        for k, i in enumerate(r["idx"]):
            assert int(i) not in got, f"scenario {i} owned by two processes"
            got[int(i)] = r["us"][k]
            assert int(r["iters"][k]) == int(ref.iters[int(i)])
    assert sorted(got) == [0, 1, 2, 3]
    for i in range(4):
        np.testing.assert_allclose(
            got[i], ref.us[i].numpy(), rtol=0, atol=1e-10,
            err_msg=f"scenario {i}: 2-process solve != single-process")
