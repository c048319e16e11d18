"""Run phases of `chip_smoke.py` alone on the card, to iterate on one of
them without the whole script.

    python3 examples/chip_phase.py 6      # the reference-shaped control loop
    python3 examples/chip_phase.py 3 5    # kernels vs plain, then phase 5

Builds the kernels as `chip_smoke.py` does, prints the card's name and
power limit, then for each phase asked for its lines, its launches per
kernel (phases 4-6) and its time on the host clock. Phases: 3 (K1-K4 and
K5a/K5b against their plain versions), 4 (the flagship, collision,
visual-servoing and batch paths), 5 (the "xla" backend and the
single-scenario solvers), 6 (the control loop). Needs a CUDA device.
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
    from agimus_controller_tpu_torch.models.panda import load_panda
    from agimus_controller_tpu_torch.ops import _build

    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    t0 = time.perf_counter()
    lib_path, _ = _build.build()
    _build.load_library()
    print(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def kernels():
        model, params = load_panda(env_urdf=cs.ENV_URDF,
                                   collision_pairs=cs.PAIR,
                                   dtype=torch.float32, device=device)
        cs.check_kernels(model, params, device)
        cs.check_step_kernels(model, params, device)
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
           6: lambda: cs.run_control_loop_phase(device)}
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
