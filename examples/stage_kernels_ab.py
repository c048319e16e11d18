"""Time the hand-written kernels K1-K5b of one checkout of the port on the GPU.

    python3 examples/stage_kernels_ab.py --root DIR [--out FILE.json]
        [--specs flagship,...] [--kernels stage,terminal,step]
        [--robot panda|tiago]

Imports `agimus_controller_tpu_torch` from DIR (this checkout or an
unpacked older one, e.g. `git archive <commit> | tar -x -C build/parent`),
builds its kernels there and times, with CUDA events (median over 50
calls, 20 at N = 409 600): K1 (`make_cuda_stage(derivs=True)`) and K2
(`derivs=False`) on `chip_smoke.py`'s checked specs at N = 19, 100 and
102 400; K3/K4 (`make_cuda_terminal`) on the same specs at N = 1, the
tick's terminal node, and 1 024; K5a/K5b (`make_cuda_step(_derivs)`) at
the batch path's N = 4 096 and 409 600 with per-node dt:

- `wrapper_ms`: one wrapper call, as `chip_smoke.py` times it;
- `kernel_ms`: the bare launch with the inputs, the refs and the outputs
  prepared (for a checkout whose wrapper has no `prepare`, the same
  launch as its `__call__`, with whatever it gathers on the torch side
  prepared too);
- `host_ms`: the host-clock time of one wrapper call without a
  synchronize (mean over 50 calls): the host's part of the call;
- `device_ms`: the device's time of one bare launch: 20 launches captured
  in one CUDA graph, so that no host submission sits between them, the
  graph replayed 10 times (median, CUDA events), per launch. `kernel_ms`
  also holds the host's submission of its one launch.

With `--robot tiago` the same on the 8-joint Tiago-Pro arm at the sizes
phase 7 launches its kernels at: K1/K2 on `chip_smoke.tiago_spec` at
`TIAGO_STAGE_SIZES`, K3/K4 at N = 1, K5a/K5b at `TIAGO_STEP_SIZES`
(`tiago_inputs` / `step_inputs` around its ready pose).
The inputs are `chip_smoke.randomized_inputs` / `step_inputs` of the
checkout that holds this script, whatever DIR is. Prints one
line per case, the card's name and power limit, the compiler's register,
stack-frame and spill figures and, where the checkout's library reports it
(`ag_step_blocks_per_sm`), the step kernels' resident blocks per SM; with
--out, writes the numbers as JSON. Run two checkouts in turns in one call
to compare them (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
SIZES = (19, 100, 102_400)
TERMINAL_SIZES = (1, 1024)
STEP_SIZES = (4096, 409_600)


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _checked(err, what):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: {err}")


def stage_launch(k, x, u, dt, t_idx, refs):
    """A callable that runs the bare launch of stage wrapper k's kernel."""
    if hasattr(k, "prepare"):  # the kernel gathers the refs itself
        args, _ = k.prepare(x, u, dt, t_idx, refs)
        return lambda: k.launch(args)
    # a wrapper that gathers the rows on the torch side: the same launch
    # as its __call__, with the rows and outputs made once
    from agimus_controller_tpu_torch.ops.cuda_dynamics import _ptr

    lib = k._lib(x)
    N, nj = x.shape[0], k.nj
    nx = 2 * nj
    rows = k._rows(refs, t_idx, x.dtype)
    new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
    if k.derivs:
        outs = (new(nx), new(nx, nx), new(nx, nj), new(), new(nx), new(nj),
                new(nx, nx), new(nx, nj), new(nj, nj))
        ptrs = [_ptr(o) for o in outs]
    else:
        outs = (new(nx), new())
        ptrs = [_ptr(outs[0]), None, None, _ptr(outs[1])] + [None] * 5
    cargs = (nj, int(k.derivs), N, _ptr(x), _ptr(u), _ptr(dt), _ptr(rows),
             k.width, _ptr(k._consts), k._consts.numel(), len(k.items), *ptrs,
             _stream(x))
    keep = (rows, outs)

    def run():
        _checked(lib.ag_stage(*cargs), "stage kernel")
        return keep

    return run


def terminal_launch(k, x, refs):
    """A callable that runs the bare launch of terminal wrapper k's kernel."""
    if hasattr(k, "prepare"):
        args, _ = k.prepare(x, refs)
        return lambda: k.launch(args)
    # the wrapper gathers the rows of t = horizon on the torch side
    from agimus_controller_tpu_torch.ops.cuda_dynamics import _ptr

    lib = k._lib(x)
    N, nx = x.shape[0], 2 * k.nj
    rows = k._rows(refs, k._t_idx(x), x.dtype)
    new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
    outs = (new(), new(nx), new(nx, nx)) if k.derivs else (new(),)
    ptrs = [_ptr(o) for o in outs] + [None] * (3 - len(outs))
    cargs = (k.nj, int(k.derivs), N, _ptr(x), _ptr(rows), k.width,
             _ptr(k._consts), k._consts.numel(), len(k.items), *ptrs,
             _stream(x))
    keep = (rows, outs)

    def run():
        _checked(lib.ag_terminal(*cargs), "terminal kernel")
        return keep

    return run


def step_launch(k, x, u, dt):
    """A callable that runs the bare launch of step wrapper k's kernel."""
    if hasattr(k, "prepare"):
        args, _ = k.prepare(x, u, dt)
        return lambda: k.launch(args)
    from agimus_controller_tpu_torch.ops import _build
    from agimus_controller_tpu_torch.ops.cuda_dynamics import _ptr

    lib = _build.load_library()
    N, nj = x.shape[0], k.nj
    nx = 2 * nj
    new = lambda *s: torch.empty((N,) + s, dtype=x.dtype, device=x.device)
    outs = (new(nx), new(nx, nx), new(nx, nj)) if k.derivs else (new(nx),)
    ptrs = [_ptr(o) for o in outs] + [None] * (3 - len(outs))
    cargs = (nj, int(k.derivs), N, _ptr(x), _ptr(u), _ptr(dt),
             _ptr(k._consts), k._consts.numel(), *ptrs, _stream(x))

    def run():
        _checked(lib.ag_step(*cargs), "step kernel")
        return outs

    return run


def graph_ms(smoke, make_bare, launches=20):
    """Device ms of one bare launch: `launches` of them captured in one
    CUDA graph (the launch's arguments prepared inside the capture, on its
    stream), the graph replayed."""
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        bare = make_bare()
        for _ in range(launches):
            bare()
    return smoke.cuda_time_ms(g.replay, reps=10) / launches


def time_case(smoke, call, make_bare, reps):
    """(wrapper ms, bare launch ms, host ms, device ms) of one case;
    make_bare() returns the bare launch's callable."""
    wrapper_ms = smoke.cuda_time_ms(call, reps=reps)
    kernel_ms = smoke.cuda_time_ms(make_bare(), reps=reps)
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    for _ in range(reps):
        call()
    host_ms = (time.perf_counter() - h0) / reps * 1e3
    torch.cuda.synchronize()
    try:
        device_ms = graph_ms(smoke, make_bare)
    except RuntimeError as e:  # a launch this checkout cannot capture
        print(f"  device time not measured: {e}")
        device_ms = float("nan")
    return wrapper_ms, kernel_ms, host_ms, device_ms


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--specs", default="flagship,full,yaml,vs,fv,cap25")
    ap.add_argument("--kernels", default="stage,terminal,step")
    ap.add_argument("--tag", default="")
    ap.add_argument("--robot", choices=("panda", "tiago"), default="panda")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stage_kernels_ab: no CUDA device")
    root = a.root.resolve()
    sys.path.insert(0, str(root))
    import agimus_controller_tpu_torch as pkg

    if Path(pkg.__file__).resolve().parent.parent != root:
        raise RuntimeError(f"port imported from {pkg.__file__}, not {root}")
    # this checkout's chip_smoke (inputs, specs, timing), whatever --root is
    spec_ = importlib.util.spec_from_file_location("chip_smoke",
                                                   HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(smoke)
    from agimus_controller_tpu_torch.models.panda import load_panda
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

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    nj = 7 if a.robot == "panda" else 8
    if hasattr(_build, "build_many"):  # one library per joint count
        _, log = _build.build(nj)
        lib = _build.load_library(nj)
    else:
        _, log = _build.build()
        lib = _build.load_library()
    print(f"[{a.tag}] {root}: built in {time.perf_counter() - t0:.1f} s; {card}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print(f"[{a.tag}]   ptxas:", line.strip())
    if a.robot == "panda":
        model, params = load_panda(env_urdf=smoke.ENV_URDF,
                                   collision_pairs=smoke.PAIR,
                                   dtype=torch.float32, device=device)
        specs = {n: smoke.SPECS[n](100, model) for n in a.specs.split(",")}
        inputs, q_ready = smoke.randomized_inputs, None
        sizes, terminal_sizes, step_sizes = SIZES, TERMINAL_SIZES, STEP_SIZES
    else:
        model, params = load_tiago_pro(dtype=torch.float32, device=device)
        specs = {"tiago": smoke.tiago_spec(smoke.TIAGO_T)}
        inputs = lambda spec, model, N, seed, device: smoke.tiago_inputs(
            spec, model, N, seed, device)
        q_ready = TIAGO_PRO_Q_READY
        sizes, terminal_sizes = smoke.TIAGO_STAGE_SIZES, (1,)
        step_sizes = smoke.TIAGO_STEP_SIZES
    out = []

    def record(name, spec_name, N, times):
        wrapper_ms, kernel_ms, host_ms, device_ms = times
        print(f"[{a.tag}] {name} {spec_name:8s} N={N:6d}  wrapper "
              f"{wrapper_ms:9.4f} ms  kernel {kernel_ms:9.4f} ms  "
              f"host {host_ms:8.4f} ms  device {device_ms:9.4f} ms")
        out.append(dict(kernel=name, spec=spec_name, N=N,
                        wrapper_ms=wrapper_ms, kernel_ms=kernel_ms,
                        host_ms=host_ms, device_ms=device_ms))

    groups = a.kernels.split(",")
    for spec_name, spec in specs.items():
        for derivs in (True, False):
            if "stage" in groups:
                k = make_cuda_stage(model, params, spec, derivs, device)
                for N in sizes:
                    refs, x, u, dt, t_idx = inputs(spec, model, N, N + derivs,
                                                   device)
                    record("K1" if derivs else "K2", spec_name, N, time_case(
                        smoke, lambda: k(x, u, dt, t_idx, refs),
                        lambda: stage_launch(k, x, u, dt, t_idx, refs), 50))
            if "terminal" in groups:
                k = make_cuda_terminal(model, params, spec, derivs, device)
                for N in terminal_sizes:
                    refs, x, _, _, _ = inputs(spec, model, N, N + derivs,
                                              device)
                    record("K3" if derivs else "K4", spec_name, N, time_case(
                        smoke, lambda: k(x, refs),
                        lambda: terminal_launch(k, x, refs), 50))
    if "step" in groups:
        for derivs in (False, True):
            k = StepKernel(model, params, derivs, device)
            if hasattr(lib, "ag_step_blocks_per_sm"):
                blocks = lib.ag_step_blocks_per_sm(k.nj, int(derivs),
                                                   k._consts.numel())
                print(f"[{a.tag}] {'K5b' if derivs else 'K5a'} resident "
                      f"blocks per SM: {blocks}")
                out.append(dict(kernel="K5b" if derivs else "K5a",
                                blocks_per_sm=blocks))
            for N in step_sizes:
                x, u, dt = smoke.step_inputs(N, N + derivs, device,
                                             "per_node", q_ready)
                record("K5b" if derivs else "K5a", "", N, time_case(
                    smoke, lambda: k(x, u, dt),
                    lambda: step_launch(k, x, u, dt),
                    50 if N <= 4096 else 20))
    if a.out:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(dict(root=str(root), tag=a.tag,
                                         card=card, rows=out), indent=1))


if __name__ == "__main__":
    main()
