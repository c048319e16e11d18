"""Time the tick paths of one checkout of the port on the GPU.

    python3 examples/paths_ab.py --root DIR [--paths collision,vs,flagship]
        [--tag NAME]

Imports `agimus_controller_tpu_torch` from DIR (this checkout or an
unpacked older one, e.g. `git archive <commit> | tar -x -C build/parent`),
builds its kernels there and runs `chip_smoke.py`'s tick paths of the
checkout that holds this script, whatever DIR is: the collision path
(`run_collision_path`), the visual-servoing path (`run_vs_path`) and the
flagship chain (`run_slice`). Prints each path's line (tick median, host
syncs, ADMM iterations, launches, checks) and the card's name and power
limit. Host-clock times move between runs: run two checkouts in turns in
one call (parent, change, change, parent) and compare only there.
"""

from __future__ import annotations

import argparse
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--paths", default="collision,vs,flagship")
    ap.add_argument("--tag", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paths_ab: no CUDA device")
    root = a.root.resolve()
    sys.path.insert(0, str(root))
    import agimus_controller_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"port imported from {pkg.__file__}, not {root}")
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    from agimus_controller_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    if hasattr(_build, "build_many"):  # one library per joint count
        _build.load_library(7)
    else:
        _build.build()
        _build.load_library()
    print(f"[{a.tag}] {root}; {card}")
    device = torch.device("cuda", 0)
    runs = {"collision": smoke.run_collision_path, "vs": smoke.run_vs_path,
            "flagship": smoke.run_slice}
    for name in a.paths.split(","):
        t0 = time.perf_counter()
        _, stats = runs[name](device)
        for line in [stats] if isinstance(stats, str) else stats:
            print(f"[{a.tag}] {line}")
        print(f"[{a.tag}] {name} path in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
