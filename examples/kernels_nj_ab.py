"""K1-K5b's nj = 8 instances (the Tiago-Pro arm) against their nj = 7
instances (the Panda), and their nj = 17 instances (the full Tiago-Pro)
against nj = 8's, at the same node counts, in one process on one card.

    python3 examples/kernels_nj_ab.py [--reps 50]

Builds the three joint counts' libraries as `chip_smoke.py` does, prints
the card's name and power limit, then for each kernel and each node count
phases 7 and 9 launch it at (`chip_smoke.TIAGO_STAGE_SIZES`, N = 1 for
K3/K4, `chip_smoke.TIAGO_STEP_SIZES`) the CUDA-event medians of the wrapper
call and of the bare launch for the three instances, with the ratios of the
bare launches (nj8/nj7, nj17/nj8); and each step kernel's resident blocks
per SM. The three instances run one cost model, `chip_smoke.tiago_spec`
(state, gravity-compensated control, a frame's translation, the same
weights): on the Tiago-Pro's left tool at nj = 8 and 17 and on the Panda's
`panda_hand_tcp` at nj = 7, with `chip_smoke.tiago_inputs` around each
robot's ready pose, so the ratios measure the joint count (and at nj = 17
the branched tree) alone. Alternates the instances per size (7, 8, 17, 17,
8, 7) and takes the mean of each pair. Needs a CUDA device.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402

NJS = (7, 8, 17)


def main(reps):
    if not torch.cuda.is_available():
        raise SystemExit("kernels_nj_ab: no CUDA device")
    cs._port()
    from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
    from agimus_controller_tpu_torch.models.tiago_pro import (
        TIAGO_PRO_Q_READY,
        load_tiago_pro,
    )
    from agimus_controller_tpu_torch.ops import _build
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    print(subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    _build.build_many(NJS)
    dev = torch.device("cuda", 0)
    robots = {7: load_panda(dtype=torch.float32, device=dev),
              8: load_tiago_pro(dtype=torch.float32, device=dev),
              17: cs.load_tiago_full(dtype=torch.float32, device=dev)}
    specs = {7: cs.tiago_spec(cs.TIAGO_T, "panda_hand_tcp"),
             8: cs.tiago_spec(cs.TIAGO_T), 17: cs.tiago_spec(cs.TIAGO_T)}
    ready = {7: PANDA_Q_READY, 8: TIAGO_PRO_Q_READY,
             17: cs.tiago_full_ready()}

    def calls(nj, name, kind, derivs, N):
        model, params = robots[nj]
        if kind == "step":
            k = StepKernel(model, params, derivs, dev)
            args = cs.step_inputs(N, N, dev, "per_node", ready[nj])
        else:
            make = make_cuda_stage if kind == "stage" else make_cuda_terminal
            k = make(model, params, specs[nj], derivs, dev)
            refs, x, u, dt, t_idx = cs.tiago_inputs(specs[nj], model, N, N,
                                                    dev, ready[nj])
            args = (x, u, dt, t_idx, refs) if kind == "stage" else (x, refs)
        prepared, _ = k.prepare(*args)
        return (cs.cuda_time_ms(lambda: k(*args), reps),
                cs.cuda_time_ms(lambda: k.launch(prepared), reps))

    for name, kind, derivs, _ in cs.STAGE_KERNELS + cs.STEP_KERNELS:
        sizes = {"stage": cs.TIAGO_STAGE_SIZES, "terminal": (1,),
                 "step": cs.TIAGO_STEP_SIZES}[kind]
        for N in sizes:
            runs = {nj: [] for nj in NJS}
            for nj in NJS + NJS[::-1]:
                runs[nj].append(calls(nj, name, kind, derivs, N))
            mean = {nj: [sum(r[i] for r in runs[nj]) / 2 for i in (0, 1)]
                    for nj in runs}
            print(f"{name:20s} N={N:6d}  " + "  ".join(
                f"nj={nj} wrapper {mean[nj][0]:.4f} ms (bare "
                f"{mean[nj][1]:.4f})" for nj in NJS)
                + f"  bare nj8/nj7 {mean[8][1] / mean[7][1]:.2f}"
                f"  bare nj17/nj8 {mean[17][1] / mean[8][1]:.2f}")
    for nj in NJS:
        consts = 31 * nj + 3
        lib = _build.load_library(nj)
        print(f"step kernels nj={nj}: resident blocks per SM K5a "
              f"{lib.ag_step_blocks_per_sm(nj, 0, consts)}, K5b "
              f"{lib.ag_step_blocks_per_sm(nj, 1, consts)}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=50)
    main(ap.parse_args().reps)
