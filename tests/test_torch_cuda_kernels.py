"""K1-K4 on the card: each CUDA kernel vs its plain-PyTorch version, f32.

Marked `cuda`: skips without a CUDA device (a CUDA kernel has no CPU
mode; its math is held against the JAX package on the CPU by
`test_torch_stage.py` through the plain versions). On a GPU machine:

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

    return load_panda(env_urdf=smoke.ENV_URDF,
                      collision_pairs=[("panda_link7_capsule", "obstacle_sphere")],
                      dtype=torch.float32, device=device)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("kernel", [k[0] for k in smoke.KERNELS])
@pytest.mark.parametrize("spec_name", ["flagship", "mixed"])
def test_kernel_matches_plain(device, panda, spec_name, kernel, N):
    from agimus_controller_tpu_torch.ops.cuda_costs import (
        make_cuda_stage,
        make_cuda_terminal,
    )

    model, params = panda
    spec = {"flagship": smoke.flagship_spec, "mixed": smoke.mixed_spec}[spec_name](100)
    _, kind, derivs, _ = next(k for k in smoke.KERNELS if k[0] == kernel)
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
