"""Run phases of `chip_smoke.py` alone on the card, to iterate on one of
them without the whole script.

    python3 examples/chip_phase.py 6      # the reference-shaped control loop
    python3 examples/chip_phase.py 3 5    # kernels vs plain, then phase 5
    python3 examples/chip_phase.py 7      # slice 12 (Tiago-Pro, soft contact,
                                          # the quaternion free-flyer)
    python3 examples/chip_phase.py 8      # slice 16: the mesh, the sharded
                                          # solvers, the batch CSQP, the
                                          # horizon-sharded Riccati, two
                                          # processes on one card
    python3 examples/chip_phase.py 9      # the full 17-DoF Tiago-Pro on the
                                          # nj = 17 kernels: the fused tick
                                          # and the batch FDDP

Builds every joint count's kernels as `chip_smoke.py`'s phase 2 does,
prints the card's name and power limit, then for each phase asked for its
lines, its launches per kernel (phases 4-9) and its time on the host clock.
Phases: 3 (K1-K4 and K5a/K5b against their plain versions, also their
nj = 8 instances on the Tiago-Pro arm and their nj = 17 instances on the
full Tiago-Pro), 4 (the flagship, collision, visual-servoing and batch
paths, the batch rows also on the horizon-parallel Riccati sweep), 5 (the
"xla" backend and the single-scenario solvers), 6 (the control loop, its
recording, checkpoint, debugger, ROS shim and publisher process), 7 (the
Tiago-Pro arm on the nj = 8 kernels, soft contact and the quaternion
free-flyer, also through the fused tick, the sensitivity sweep), 8 (the
multi-device layer over four slots of the card: the batch-sharded SQP on
K1-K4, the batch-sharded FDDP and the batch CSQP on K5a/K5b, the
horizon-sharded Riccati in f64, two processes sharing the card), 9 (the
full 17-DoF Tiago-Pro through the fused tick and the batch FDDP on the
nj = 17 kernels). Needs a CUDA device.
"""

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main(phases):
    if not torch.cuda.is_available():
        raise SystemExit("chip_phase: no CUDA device")
    cs._port()
    from agimus_controller_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    cs.build_kernels(_build)
    print(f"phase 2 took {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def kernels():
        cs.check_all_kernels(device)
        return {}, []

    def paths():
        launches, lines = {}, []
        for run in (cs.run_slice, cs.run_collision_path, cs.run_vs_path,
                    cs.run_batch_path):
            got, stats = run(device)
            lines += [stats] if isinstance(stats, str) else stats
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
        return launches, lines

    run = {3: kernels, 4: paths,
           5: lambda: cs.run_fallback_phase(device),
           6: lambda: cs.run_control_loop_phase(device),
           7: lambda: cs.run_slice12_phase(device),
           8: lambda: cs.run_multi_device_phase(device),
           9: lambda: cs.run_full_tiago_phase(device)}
    for phase in phases:
        t0 = time.perf_counter()
        launches, lines = run[phase]()
        for line in lines:
            print(line)
        if launches:
            print(f"phase {phase} launches {launches}")
        print(f"phase {phase} took {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [6])
