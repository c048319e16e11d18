"""The batch FDDP's Riccati sweep kernel on the CPU: its wrapper, its route
and its per-thread program.

- `RiccatiKernel` on CPU tensors is `backward_components`, result for
  result, and launches nothing; its checks refuse another dtype than
  float32, a shape off the sweep's and a tensor that is not contiguous;
- `BatchFDDP` lists the wrapper among its kernels for a rigid state and
  its component sweep goes through it; soft contact and a Lie-group state
  (their state is not the kernel's [q; v]) take `backward_components`, the
  dense and horizon-parallel sweeps are their own;
- the kernel's phases (`csrc/riccati_kernels.cuh`), built with g++ into a
  host library (`tests/riccati_lanes_harness.cpp`: each phase thread by
  thread over NaN-filled shared memory, as the barriers order them on the
  card), against the plain sweep in float32 and in float64 on seeded LQ
  data (`chip_smoke.random_lq`: reg per scenario, one scenario with a NaN
  input, one with an indefinite Quu) by `chip_smoke.riccati_check`: the
  same `bad` scenarios and non-finite entries, and an error against
  float64 within twice the plain float32 sweep's plus `RICCATI_FLOOR`.
  Skips only without g++.

On the card the kernel itself is held by `test_torch_cuda_riccati.py`.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

import chip_smoke as smoke
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu_torch.ocp.spec import default_references
from agimus_controller_tpu_torch.ops.cuda_riccati import RiccatiKernel
from agimus_controller_tpu_torch.solver import fddp_batch
from agimus_controller_tpu_torch.solver.fddp import SolverSettings
from agimus_controller_tpu_torch.solver.fddp_batch import make_batch_fddp
from agimus_controller_tpu_torch.solver.riccati_components import (
    backward_components,
)
from chip_smoke import random_lq, riccati_check

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "agimus_controller_tpu_torch" / "csrc"
HARNESS = ROOT / "tests" / "riccati_lanes_harness.cpp"
CPU = torch.device("cpu")


def f32(args):
    return [a.float() for a in args]


# ---------------------------------------------------------------------------
# the wrapper on CPU tensors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_is_the_plain_sweep(dtype):
    args = [a.to(dtype) for a in random_lq(6, 4, 3, seed=1)]
    k = RiccatiKernel(3, CPU)
    got, want = k(*args), backward_components(*args)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.nan_to_num(7.0),
                                                  w.nan_to_num(7.0))
    assert k.launches == 0
    assert got[5].tolist() == [False, True, True, False]


def _contiguity(args):
    args[4] = args[4].transpose(-1, -2).contiguous().transpose(-1, -2)
    return args


BAD_INPUTS = {
    "float64": (TypeError, lambda a: a[:10] + [a[10].double()]),
    "lxu_float16": (TypeError, lambda a: a[:5] + [a[5].half()] + a[6:]),
    "nx_not_2nj": (ValueError, lambda a: [a[0][..., :4, :4]] + a[1:]),
    "lx_horizon": (ValueError, lambda a: a[:2] + [a[2][1:]] + a[3:]),
    "fs_rows_T": (ValueError, lambda a: a[:7] + [a[7][1:]] + a[8:]),
    "reg_batch": (ValueError, lambda a: a[:10] + [a[10][:2]]),
    "term_lxx_flat": (ValueError, lambda a: a[:9] + [a[9].flatten(1)] + a[10:]),
    "lxx_not_contiguous": (ValueError, _contiguity),
    "ten_arguments": (TypeError, lambda a: a[:10]),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_wrapper_checks(case):
    err, edit = BAD_INPUTS[case]
    args = f32(random_lq(5, 3, 3, seed=2))
    k = RiccatiKernel(3, CPU)
    assert k.check(*args) == (5, 3)
    with pytest.raises(err):
        k.check(*edit(args))


def test_wrapper_refuses_a_cpu_launch():
    """`prepare` is the card's: a wrapper built for the CPU does not load
    the kernel library."""
    with pytest.raises(ValueError, match="built for cpu"):
        RiccatiKernel(3, CPU).prepare(*f32(random_lq(2, 2, 3, seed=3)))


# ---------------------------------------------------------------------------
# the batch FDDP's route
# ---------------------------------------------------------------------------

def _spy(calls, fn):
    def spy(*a):
        calls.append(a[0].shape)
        return fn(*a)
    return spy


def _sweep_inputs(solver, nx, nu, B=2):
    """Seeded LQ data of the solver's horizon as `backward` takes it."""
    Fx, Fu, lx, lu, lxx, lxu, luu, fs, tlx, tlxx, reg = random_lq(
        solver.T, B, nu, seed=4, nx=nx)
    return ((None, Fx, Fu), (None, lx, lu, lxx, lxu, luu),
            (None, tlx, tlxx), fs, reg)


def panda(riccati="component", T=4):
    """`make_batch_fddp` on the flagship Panda spec, float64 on the CPU,
    with refs that hold the ready state; (solver, refs, x0)."""
    model, params = load_panda(dtype=torch.float64, device=CPU)
    spec = smoke.flagship_spec(T)
    refs = default_references(spec, model, dtype=torch.float64, device=CPU)
    x0 = torch.cat([torch.as_tensor(PANDA_Q_READY, dtype=torch.float64),
                    torch.zeros(7, dtype=torch.float64)])
    refs["xref"] = x0.expand(T + 1, 14).contiguous()
    return make_batch_fddp(model, params, spec, SolverSettings(max_iters=1),
                           riccati=riccati, device=CPU), refs, x0


def test_rigid_state_takes_the_wrapper(monkeypatch):
    """The flagship Panda spec: the wrapper is the solver's third kernel,
    and every component sweep of a solve goes through it (on the CPU to its
    plain version), one a loop iteration and one for the report."""
    solver, refs, x0 = panda()
    assert isinstance(solver.kernels[2], RiccatiKernel)
    assert solver.kernels[2] is solver.riccati_k and solver.riccati_k.nj == 7
    calls = []
    monkeypatch.setattr(solver.riccati_k, "plain",
                        _spy(calls, backward_components))
    monkeypatch.setattr(fddp_batch, "backward_components",
                        lambda *a: pytest.fail("the plain sweep was called"))
    solver.backward(*_sweep_inputs(solver, 14, 7))
    assert calls == [(4, 2, 14, 14)]
    calls.clear()
    sol = solver(x0.expand(2, 14), refs, x0.expand(2, 5, 14).contiguous(),
                 torch.zeros(2, 4, 7, dtype=torch.float64))
    assert len(calls) == int(sol.iters.max()) + 1 >= 2
    assert solver.riccati_k.launches == 0


@pytest.mark.parametrize("riccati", ["dense", "pscan"])
def test_other_sweeps_bypass_the_wrapper(monkeypatch, riccati):
    solver, _, _ = panda(riccati)
    monkeypatch.setattr(solver.riccati_k, "plain",
                        lambda *a: pytest.fail("the component sweep ran"))
    out = solver.backward(*_sweep_inputs(solver, 14, 7))
    assert out[1].shape == (4, 2, 7, 14)


@pytest.mark.parametrize("state", ["soft", "manifold"])
def test_other_states_take_the_plain_sweep(monkeypatch, state):
    """Soft contact ([q; v; f]) and the free-flyer's tangent space: no
    kernels; `backward_components` runs their component sweep."""
    if state == "soft":
        p = smoke.force_problem(CPU, dtype=torch.float64)
        solver = make_batch_fddp(p.model, p.params, p.spec, device=CPU)
        nx = 17
    else:
        p = smoke.ff_problem(CPU, dtype=torch.float64, T=3)
        solver = make_batch_fddp(p.model, p.params, p.spec, device=CPU,
                                 cf=p.cf)
        nx = p.cf.ntan
    nu = p.model.nj
    assert solver.kernels == () and not hasattr(solver, "riccati_k")
    calls = []
    monkeypatch.setattr(fddp_batch, "backward_components",
                        _spy(calls, backward_components))
    solver.backward(*_sweep_inputs(solver, nx, nu))
    assert calls == [(solver.T, 2, nx, nx)]


# ---------------------------------------------------------------------------
# the kernel's per-thread program, as host C++
# ---------------------------------------------------------------------------

_LIBS = {}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """nj -> the harness library of nj joints, built at first use."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel's host harness")
    out_dir = tmp_path_factory.mktemp("riccati_lanes")

    def lib(nj):
        if nj not in _LIBS:
            out = out_dir / f"libriccati_lanes_nj{nj}.so"
            subprocess.run(
                [shutil.which("g++"), "-std=c++17", "-O2", "-shared", "-fPIC",
                 f"-DAG_NJ={nj}", "-I", str(CSRC), "-o", str(out),
                 str(HARNESS)], check=True, capture_output=True, text=True)
            so = ctypes.CDLL(str(out))
            so.ag_riccati_host.argtypes = ([ctypes.c_int] * 3
                                           + [ctypes.c_void_p] * 17)
            so.ag_riccati_host.restype = ctypes.c_int
            _LIBS[nj] = so
        return _LIBS[nj]
    return lib


def host_sweep(lib, nj, args):
    """The harness's sweep on float32 inputs: (ks, Ks, Qus, d1, d2, bad)."""
    T, B = args[0].shape[:2]
    nx, nu = 2 * nj, nj
    outs = (torch.empty(T, B, nu), torch.empty(T, B, nu, nx),
            torch.empty(T, B, nu), torch.empty(B), torch.empty(B),
            torch.empty(B, dtype=torch.bool))
    p = lambda t: ctypes.c_void_p(t.data_ptr())
    assert lib.ag_riccati_host(nj, T, B, *(p(a) for a in args),
                               *(p(o) for o in outs)) == 0
    return outs


# two builds, the Panda's count and the full Tiago-Pro's; the plain sweep's
# CPU ops grow with T and nj^2 (~3 000 a step at 17 joints): the long
# horizon and T = 1 at 7 joints, the 17 joints at a short one
@pytest.mark.parametrize("nj,T,B", [(7, 1, 3), (7, 5, 4), (7, 100, 5),
                                    (17, 3, 3)])
def test_lanes_match_the_plain_sweep(host_lib, nj, T, B):
    a64 = random_lq(T, B, nj, seed=10 * nj + T)
    got = host_sweep(host_lib(nj), nj, f32(a64))
    riccati_check(f"nj={nj} T={T} B={B}", got,
                  backward_components(*f32(a64)), backward_components(*a64))
    assert got[5].tolist() == [False, True, True] + [False] * (B - 3)


def test_lanes_with_a_wrong_joint_count(host_lib):
    lib = host_lib(7)
    z = ctypes.c_void_p(0)
    assert lib.ag_riccati_host(3, 1, 1, *([z] * 17)) == 1
