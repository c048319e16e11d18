"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

One library per joint count: `nvcc` compiles every source under `csrc/`
with `-DAG_NJ=<nj>` into a shared library that holds that count's instance
of each kernel, with a plain C interface, loaded with `ctypes` (no PyTorch
headers): one `nvcc` per source, all started together, then one link per
count. A count's library is built at its first use (`load_library(nj)`),
into `build/kernels/` under the repository root, and again when the content
hash of the sources and the flags changes; `build_many(njs)` starts every
source of every count asked for at once. A build or load failure raises
with the compiler's output; nothing falls back.
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


def nvcc_flags(nj: int) -> tuple:
    """The compile flags of nj's library: `NVCC_FLAGS` and its count."""
    if int(nj) != nj or nj < 1:
        raise ValueError(f"joint count {nj!r} is not a positive integer")
    return NVCC_FLAGS + (f"-DAG_NJ={int(nj)}",)


def library_path(nj: int) -> Path:
    """Path of nj's library for the current sources and flags
    (content-addressed)."""
    flags = nvcc_flags(nj)
    h = hashlib.sha256(" ".join(flags).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libagimus_kernels_nj{int(nj)}_{h.hexdigest()[:16]}.so"


def compile_commands(nj: int, stem: str) -> list:
    """(nvcc command, object path) of each source of nj's library, the
    objects named after `stem`."""
    return [([_nvcc(), *nvcc_flags(nj), "-c", "-o", str(obj), str(src)], obj)
            for src in sorted(CSRC.glob("*.cu"))
            for obj in [BUILD_DIR / f"{stem}.{src.stem}.o"]]


def build_many(njs) -> list:
    """Compiles the libraries of the joint counts `njs` that are missing,
    every source of every count at once; returns [(path, the compilers'
    output, empty when the library was already there)] in njs's order."""
    njs = list(dict.fromkeys(int(nj) for nj in njs))
    outs = {nj: library_path(nj) for nj in njs}
    todo = [nj for nj in njs if not outs[nj].is_file()]
    logs = {nj: "" for nj in njs}
    if not todo:
        return [(outs[nj], logs[nj]) for nj in njs]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {nj: [(cmd, obj, subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for cmd, obj in compile_commands(
            nj, f"{outs[nj].stem}.{os.getpid()}")] for nj in todo}
    failed = []
    for nj in todo:
        for cmd, _, proc in jobs[nj]:
            out = proc.communicate()[0]
            logs[nj] += out
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): "
                              f"{' '.join(cmd)}\n{out}")
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        for nj in todo:
            tmp = outs[nj].with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *(str(obj) for _, obj, _ in jobs[nj])]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{proc.stderr}")
            # atomic: a concurrent build never loads a partial file
            os.replace(tmp, outs[nj])
    finally:
        for nj in todo:
            for _, obj, _ in jobs[nj]:
                obj.unlink(missing_ok=True)
    return [(outs[nj], logs[nj]) for nj in njs]


def build(nj: int) -> tuple:
    """`build_many([nj])`'s one entry: (path, the compilers' output)."""
    return build_many([nj])[0]


@functools.cache
def load_library(nj: int) -> ctypes.CDLL:
    """Build (if needed) and load nj's kernel library, with C signatures."""
    path, _ = build(nj)
    lib = ctypes.CDLL(str(path))
    p, i = ctypes.c_void_p, ctypes.c_int
    # nj, derivs, N, x, u, dt, t_idx, &RefTable, W, consts, consts_len,
    # n_items, 9 outputs, stream
    lib.ag_stage.argtypes = [i, i, i, p, p, p, p, p, i, p, i, i,
                             p, p, p, p, p, p, p, p, p, p]
    lib.ag_stage.restype = i
    # nj, derivs, N, x, &RefTable, t, W, consts, consts_len, n_items,
    # l, lx, lxx, stream
    lib.ag_terminal.argtypes = [i, i, i, p, p, i, i, p, i, i, p, p, p, p]
    lib.ag_terminal.restype = i
    lib.ag_step.argtypes = [i, i, i, p, p, p, p, i, p, p, p, p]
    lib.ag_step.restype = i
    # nj, derivs, consts_len -> resident blocks per SM of ag_step's kernel
    lib.ag_step_blocks_per_sm.argtypes = [i, i, i]
    lib.ag_step_blocks_per_sm.restype = i
    # nj, T, B, 11 inputs, 6 outputs, stream
    lib.ag_riccati.argtypes = [i, i, i] + [p] * 18
    lib.ag_riccati.restype = i
    lib.ag_error_string.argtypes = [i]
    lib.ag_error_string.restype = ctypes.c_char_p
    lib.ag_nj.argtypes = []
    lib.ag_nj.restype = i
    if lib.ag_nj() != nj:
        raise RuntimeError(f"{path} holds the kernels of {lib.ag_nj()} "
                           f"joints, not {nj}")
    return lib


def error_string(nj: int, err: int) -> str:
    return f"{err} ({load_library(nj).ag_error_string(err).decode()})"
