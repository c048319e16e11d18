"""One process of the port's two-process sharded solve, launched (never
collected) by `tests/test_torch_distributed.py::
test_two_process_sharded_solve`:

    AGIMUS_COORDINATOR=localhost:PORT AGIMUS_NUM_PROCESSES=2 \
    AGIMUS_PROCESS_ID=RANK python tests/_torch_distributed_worker.py OUT cpu

It joins the group through the `AGIMUS_*` environment, lays out the global
mesh, places its own scenarios with `host_local_to_global`, runs the
sharded batch SQP and writes its rows (`chip_smoke.distributed_worker`,
which phase 8 (e) runs on the card). It imports no JAX.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    chip_smoke.distributed_worker(sys.argv[1], sys.argv[2])
