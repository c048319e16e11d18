"""How far float32 takes the Euler step of the full 17-DoF Tiago-Pro from its
float64 value, with and without armature.

    python3 examples/full_tiago_f32_step.py [--device cuda|cpu] [--nodes 1024]

On `chip_smoke.py`'s step-kernel check nodes (`chip_smoke.step_inputs`
around `tiago_full_ready()`, per-node dt, the seed of phase 3's K5a check)
prints, for the loader's full model (`load_tiago_pro(moving_joint_names=
"all")`, no armature) and for `chip_smoke.load_tiago_full` (the reduced
model's 0.05 armature on every joint): the largest |v+|, and the largest
x+ error against the plain step in float64 of the plain step in float32
and, on the card, of K5a, with their largest difference, beside `TOL`'s
absolute x+ bound. Without armature the wrists' ~1e-3 kg m^2 are all their
mass matrix holds, and the check's random torques take them past 100 rad/s
in one step.
"""

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main(device, n):
    cs._port()
    from agimus_controller_tpu_torch.models.tiago_pro import load_tiago_pro
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    if device.type == "cuda":
        print(subprocess.run(["nvidia-smi", "-i", "0",
                              "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    models = {
        "no armature": lambda dtype, dev="cpu": load_tiago_pro(
            moving_joint_names="all", dtype=dtype, device=dev),
        "armature 0.05": lambda dtype, dev="cpu": cs.load_tiago_full(dtype,
                                                                     dev)}
    x, u, dt = cs.step_inputs(n, n, "cpu", "per_node", cs.tiago_full_ready())
    for name, load in models.items():
        m32, p32 = load(torch.float32)
        m64, p64 = load(torch.float64)
        exact = StepKernel(m64, p64, False, "cpu").plain(
            x.double(), u.double(), dt.double())
        plain = StepKernel(m32, p32, False, "cpu").plain(x, u, dt)
        line = (f"{name}: max |v+| {float(exact[:, 17:].abs().max()):.1f} "
                f"rad/s; x+ against f64: plain f32 "
                f"{float((plain.double() - exact).abs().max()):.3e}")
        if device.type == "cuda":
            k = StepKernel(*load(torch.float32, device), False, device)
            got = k(x.to(device), u.to(device), dt.to(device)).cpu()
            line += (f", K5a {float((got.double() - exact).abs().max()):.3e}"
                     f", K5a - plain {float((got - plain).abs().max()):.3e}")
        print(f"{line} (TOL x+ atol {cs.TOL['xnext'][0]})")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nodes", type=int, default=1024)
    a = ap.parse_args()
    main(torch.device(a.device), a.nodes)
