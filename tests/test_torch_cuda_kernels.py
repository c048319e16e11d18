"""K1-K5b on the card: each CUDA kernel vs its plain-PyTorch version, f32.

Marked `cuda`: skips without a CUDA device (a CUDA kernel has no CPU
mode; its math is held against the JAX package on the CPU by
`test_torch_stage.py` through the plain versions). The specs are
`chip_smoke.py`'s: the flagship goal tracking, the Pallas test spec without
("mixed") and with ("full") its collision item, the shipped
collision-avoidance YAML, the visual-servoing OCP ("vs") and the
visual-servoing + frame-velocity spec ("fv"); the inputs keep the
collision, visual-servoing and frame-velocity terms live. The step kernels
K5a/K5b take random Panda nodes with v and u live, with per-node and
scalar dt. On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

(`--noconftest`: the suite's conftest configures JAX, which this file does
not use.) Tolerances are those of the Pallas kernels' tests.
"""

import pytest
import torch

import chip_smoke as smoke

pytestmark = pytest.mark.cuda

SIZES = (100, 4096)


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stage kernels run only on the GPU")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def panda(device):
    from agimus_controller_tpu_torch.models.panda import load_panda

    return load_panda(env_urdf=smoke.ENV_URDF, collision_pairs=smoke.PAIR,
                      dtype=torch.float32, device=device)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("kernel", [k[0] for k in smoke.STAGE_KERNELS])
@pytest.mark.parametrize("spec_name", ["flagship", "mixed", "full", "yaml",
                                       "vs", "fv"])
def test_kernel_matches_plain(device, panda, spec_name, kernel, N):
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    model, params = panda
    spec = smoke.SPECS[spec_name](100, model)
    _, kind, derivs, _ = next(k for k in smoke.STAGE_KERNELS if k[0] == kernel)
    refs, x, u, dt, t_idx = smoke.randomized_inputs(spec, model, N, seed=N,
                                                    device=device)
    if kind == "stage":
        k = make_cuda_stage(model, params, spec, derivs, device)
        got, want = k(x, u, dt, t_idx, refs), k.plain(x, u, dt, t_idx, refs)
        labels = smoke.STAGE_OUT if derivs else ("xnext", "l")
    else:
        k = make_cuda_terminal(model, params, spec, derivs, device)
        got, want = k(x, refs), k.plain(x, refs)
        labels = ("l", "lx", "lxx") if derivs else ("l",)
    torch.cuda.synchronize()
    assert k.launches == 1
    smoke.check_outputs(f"{kernel} {spec_name} N={N}", got, want, labels)


def test_wrapper_rejects_bad_inputs(device, panda):
    from agimus_controller_tpu_torch.ops.cuda_costs import make_cuda_stage

    model, params = panda
    spec = smoke.flagship_spec(100)
    refs, x, u, dt, t_idx = smoke.randomized_inputs(spec, model, 100, seed=0,
                                                    device=device)
    k = make_cuda_stage(model, params, spec, False, device)
    with pytest.raises(TypeError):
        k(x.double(), u, dt, t_idx, refs)
    with pytest.raises(ValueError):
        k(x.t().contiguous().t(), u, dt, t_idx, refs)
    with pytest.raises(ValueError):
        k(x, u[:50], dt, t_idx, refs)
    assert k.launches == 0


@pytest.mark.parametrize("dt_kind", ["per_node", "scalar"])
@pytest.mark.parametrize("N", (13, 4096))
@pytest.mark.parametrize("kernel", [k[0] for k in smoke.STEP_KERNELS])
def test_step_kernel_matches_plain(device, panda, kernel, N, dt_kind):
    from agimus_controller_tpu_torch.ops.cuda_dynamics import StepKernel

    model, params = panda
    derivs = kernel == "K5b_step_derivs"
    x, u, dt = smoke.step_inputs(N, N, device, dt_kind)
    k = StepKernel(model, params, derivs, device)
    got, want = k(x, u, dt), k.plain(x, u, dt)
    torch.cuda.synchronize()
    assert k.launches == 1
    if not derivs:
        got, want = (got,), (want,)
    smoke.check_outputs(f"{kernel} N={N} {dt_kind} dt", got, want,
                        ("xnext", "Fx", "Fu")[:len(got)])


def test_step_wrapper_rejects_bad_inputs(device, panda):
    from agimus_controller_tpu_torch.ops.cuda_dynamics import make_cuda_step

    model, params = panda
    x, u, dt = smoke.step_inputs(64, 0, device, "per_node")
    k = make_cuda_step(model, params, device)
    with pytest.raises(TypeError):
        k(x.double(), u, dt)
    with pytest.raises(ValueError):
        k(x.t().contiguous().t(), u, dt)
    with pytest.raises(ValueError):
        k(x, u, dt[:10])
    with pytest.raises(ValueError):
        k(x, u.cpu(), dt)
    assert k.launches == 0
