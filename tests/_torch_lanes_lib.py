"""The kernels' per-lane programs as host C++: `tests/stage_lanes_harness.cpp`
built with g++ once per joint count (`-DAG_NJ=<nj>`, as `ops/_build.py`
builds the kernels), at the count's first use.

`HostLibs(out_dir)` is what the lane tests take as `host_lib`: each entry
point `ag_stage_host`, `ag_terminal_host`, `ag_terminal_node_host` and
`ag_step_host` dispatches on its first argument, nj, to that count's
library; `lib(nj)` is the library itself (`ag_smem_floats_host`). A count
is built once per process: the lane test files that one worker runs share
its libraries.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "agimus_controller_tpu_torch" / "csrc"
HARNESS = ROOT / "tests" / "stage_lanes_harness.cpp"
_LIBS = {}  # nj -> the loaded library, for the process


def gxx_command(nj: int, out: Path) -> list:
    """The g++ command that builds nj's harness library into out."""
    return [shutil.which("g++") or "g++", "-std=c++17", "-O2", "-shared",
            "-fPIC", f"-DAG_NJ={nj}", "-I", str(CSRC), "-o", str(out),
            str(HARNESS)]


class HostLibs:
    """nj -> the harness library of nj joints, built at first use."""

    ENTRIES = ("ag_stage_host", "ag_terminal_host", "ag_terminal_node_host",
               "ag_step_host")

    def __init__(self, out_dir: Path):
        self.out_dir = Path(out_dir)

    def lib(self, nj: int) -> ctypes.CDLL:
        if nj not in _LIBS:
            out = self.out_dir / f"libstage_lanes_nj{nj}.so"
            subprocess.run(gxx_command(nj, out), check=True,
                           capture_output=True, text=True)
            lib = ctypes.CDLL(str(out))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.ag_stage_host.argtypes = ([i, i, i, p, p, p, p, p, i, p, i, i]
                                          + [p] * 9)
            lib.ag_terminal_host.argtypes = [i, i, i, p, p, i, i, p, i, i, p,
                                             p, p]
            lib.ag_terminal_node_host.argtypes = [i, i, p, p, i, i, p, i, p,
                                                  p, p]
            lib.ag_step_host.argtypes = [i, i, i, i, p, p, p, p, p, p, p]
            lib.ag_smem_floats_host.argtypes = [i, i, i, i]
            for name in self.ENTRIES + ("ag_smem_floats_host",):
                getattr(lib, name).restype = i
            _LIBS[nj] = lib
        return _LIBS[nj]

    def __getattr__(self, name):
        if name not in self.ENTRIES:
            raise AttributeError(name)
        return lambda nj, *args: getattr(self.lib(nj), name)(nj, *args)
