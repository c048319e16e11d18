"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles every source under `csrc/` into one shared library with a
plain C interface, loaded with `ctypes` (no PyTorch headers): one `nvcc`
per source, all started together, then one link. The build happens at
first use, into `build/kernels/` under the repository root, and is redone
when the sources' content hash changes. A build or load failure raises with
the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                           "-Xptxas", "-v")


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels")


def library_path() -> Path:
    """Path of the library for the current sources (content-addressed)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libagimus_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing; returns (path, the
    compilers' output, empty when the library was already there)."""
    out = library_path()
    if out.is_file():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    jobs = []  # one nvcc per source, all running at once
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{stem}.{src.stem}.o"
        cmd = [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for cmd, _, proc in jobs:
        logs.append(proc.communicate()[0])
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                          f"{logs[-1]}")
    objs = [obj for _, obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(logs)


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with C signatures."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ag_stage.argtypes = [i, i, i, p, p, p, p, i, p, i, i,
                             p, p, p, p, p, p, p, p, p, p]
    lib.ag_stage.restype = i
    lib.ag_terminal.argtypes = [i, i, i, p, p, i, p, i, i, p, p, p, p]
    lib.ag_terminal.restype = i
    lib.ag_step.argtypes = [i, i, i, p, p, p, p, i, p, p, p, p]
    lib.ag_step.restype = i
    lib.ag_error_string.argtypes = [i]
    lib.ag_error_string.restype = ctypes.c_char_p
    return lib


def error_string(err: int) -> str:
    return f"{err} ({load_library().ag_error_string(err).decode()})"
