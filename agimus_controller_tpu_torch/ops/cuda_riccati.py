"""The batch FDDP's Riccati backward pass as one CUDA launch a sweep.

`RiccatiKernel` launches `csrc/riccati_kernels.cu::ag_riccati` on CUDA
tensors and runs its plain version, `solver/riccati_components.py::
backward_components`, on CPU tensors; a CUDA tensor reaches the kernel or the
wrapper raises. It takes the sweep's arguments and returns its results:

    (Fx [T,B,nx,nx], Fu [T,B,nx,nu], lx [T,B,nx], lu [T,B,nu],
     lxx [T,B,nx,nx], lxu [T,B,nx,nu], luu [T,B,nu,nu], fs [T+1,B,nx],
     term_lx [B,nx], term_lxx [B,nx,nx], reg [B])
      -> (ks [T,B,nu], Ks [T,B,nu,nx], Qus [T,B,nu], d1 [B], d2 [B], bad [B])

for a rigid state, nx = 2 nj and nu = nj, in float32, every input contiguous
and time-major, as `BatchFDDP.derivs_of` and `_gaps_of` produce them.

The kernel replaces no TPU kernel: the JAX package's sweep
(`agimus_controller_tpu/solver/riccati_components.py`) is XLA. It was added
because the plain sweep dispatches ~3 000 PyTorch ops a step at 17 joints
(the Cholesky and the solves unrolled one op a scalar, every product a
broadcast in device memory before its reduction). Its bound at B = 4 096,
T = 20, nj = 17: 4 454 floats a node read or written once (Fx, Fu, lxx, lxu,
luu, lx, lu, fs in; Ks, ks, Qus out), 1.46 GB a sweep, 0.44 ms at 3.35
TB/s; ~163 k FMA a node, 26.7 GFLOP a sweep, 0.40 ms at 67 TFLOP/s fp32. The
design (one block a scenario walking t = T-1 ... 0 with Vx and Vxx in shared
memory, the next step's inputs prefetched by cp.async, register-tiled
products, the Cholesky on one warp) is described in the source.
"""

from __future__ import annotations

import ctypes

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..solver.riccati_components import backward_components
from . import _build
from .cuda_dynamics import _ptr


ARGS = ("Fx", "Fu", "lx", "lu", "lxx", "lxu", "luu", "fs", "term_lx",
        "term_lxx", "reg")


class RiccatiKernel:
    """`__call__(Fx, Fu, lx, lu, lxx, lxu, luu, fs, term_lx, term_lxx, reg)`
    -> (ks, Ks, Qus, d1, d2, bad), the batch FDDP's component sweep for nj
    joints (see the module)."""

    def __init__(self, nj: int, device: torch.device | str = DEFAULT_DEVICE):
        self.device = resolve_device(device)
        self.nj = nj
        self.launches = 0  # kernel launches (CUDA path only)

    plain = staticmethod(backward_components)

    def __call__(self, *args):
        if args[0].device.type == "cpu":
            return self.plain(*args)
        cargs, outs = self.prepare(*args)
        self.launch(cargs)
        return outs

    def check(self, *args) -> tuple:
        """Raises on what the kernel does not take: another dtype than
        float32, a tensor on another device than Fx's, a shape off the
        sweep's at this joint count, a tensor that is not contiguous.
        Returns (T, B)."""
        if len(args) != len(ARGS):
            raise TypeError(f"expected the {len(ARGS)} arguments {ARGS}")
        Fx = args[0]
        if Fx.ndim != 4:
            raise ValueError(f"Fx must be [T, B, nx, nx], got {tuple(Fx.shape)}")
        T, B = Fx.shape[:2]
        nx, nu = 2 * self.nj, self.nj
        shapes = ((T, B, nx, nx), (T, B, nx, nu), (T, B, nx), (T, B, nu),
                  (T, B, nx, nx), (T, B, nx, nu), (T, B, nu, nu),
                  (T + 1, B, nx), (B, nx), (B, nx, nx), (B,))
        for name, t, shape in zip(ARGS, args, shapes):
            if t.device != Fx.device:
                raise ValueError(f"{name} is on {t.device}, Fx on {Fx.device}")
            if t.dtype != torch.float32:
                raise TypeError(
                    f"{name} must be float32 for the CUDA kernel, got {t.dtype}")
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} has shape {tuple(t.shape)}, expected {shape} "
                    f"(nj={self.nj})")
            if not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        return T, B

    def prepare(self, *args):
        """Checks the inputs and allocates the outputs: returns (the
        launch's arguments, the outputs)."""
        T, B = self.check(*args)
        if self.device.type != "cuda" or args[0].device != self.device:
            raise ValueError(
                f"wrapper built for {self.device}, called with "
                f"{args[0].device}")
        lib = _build.load_library(self.nj)
        nx, nu = 2 * self.nj, self.nj
        new = lambda *s, dtype=torch.float32: torch.empty(
            s, dtype=dtype, device=self.device)
        outs = (new(T, B, nu), new(T, B, nu, nx), new(T, B, nu), new(B),
                new(B), new(B, dtype=torch.bool))
        cargs = (lib, (self.nj, T, B, *(_ptr(t) for t in args),
                       *(_ptr(o) for o in outs),
                       ctypes.c_void_p(
                           torch.cuda.current_stream(self.device).cuda_stream)),
                 (args, outs))
        return cargs, outs

    def launch(self, cargs):
        """One launch of the kernel on prepared arguments (`prepare`)."""
        lib, c, _ = cargs
        err = lib.ag_riccati(*c)
        if err != 0:
            raise RuntimeError(
                f"Riccati kernel launch failed: "
                f"{_build.error_string(self.nj, err)} (nj={self.nj})")
        self.launches += 1

