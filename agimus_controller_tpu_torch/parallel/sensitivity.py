"""Model-parameter sensitivity sweeps, batched over `ModelParams`.

Reference: the model-sensitivity study
(`agimus_controller_examples/main/model_sensibility/evaluate_model_sensibility.py:9-134`)
perturbs per-link inertia (6), CoM (3) and mass (1) one at a time and
integrates one Euler step per perturbation in a serial python loop. Because
`ModelParams` is a tuple of tensors, the same study here is ONE call of the
Euler step vmapped (`torch.func.vmap`) over a stacked params tuple, on the
params' device.

Port of the JAX package's `parallel/sensitivity.py`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..models.model import ModelParams, RobotModel
from ..ops import integrator


def perturbed_params_batch(
    params: ModelParams,
    rel_step: float = 1e-3,
    abs_step: float = 1e-6,
) -> Tuple[ModelParams, list]:
    """Stack one-at-a-time perturbations of (inertia[6], com[3], mass[1]) for
    every body: returns a ModelParams with leading axis B = nj * 10 + 1
    (row 0 unperturbed) and the matching labels."""
    nj = params.mass.shape[0]
    I0, c0, m0 = params.inertia, params.com, params.mass
    rows = [(I0, c0, m0)]  # (inertia, com, mass) of each row
    labels = ["nominal"]
    iu = [(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]
    for j in range(nj):
        for (a, b) in iu:
            dI = I0[j, a, b] * rel_step + abs_step
            inertia = I0.clone()
            inertia[j, a, b] += dI
            if a != b:
                inertia[j, b, a] += dI
            rows.append((inertia, c0, m0))
            labels.append(f"body{j}_I{a}{b}")
        for axis in range(3):
            com = c0.clone()
            com[j, axis] += c0[j, axis] * rel_step + abs_step
            rows.append((I0, com, m0))
            labels.append(f"body{j}_com{axis}")
        mass = m0.clone()
        mass[j] += m0[j] * rel_step + abs_step
        rows.append((I0, c0, mass))
        labels.append(f"body{j}_mass")
    B = len(rows)
    perturbed = dict(zip(("inertia", "com", "mass"),
                         (torch.stack(f) for f in zip(*rows))))
    stacked = ModelParams(*(
        perturbed[f] if f in perturbed
        else getattr(params, f).expand((B,) + getattr(params, f).shape)
        for f in ModelParams._fields))
    return stacked, labels


def next_state_sensitivity(
    model: RobotModel,
    params: ModelParams,
    x0,
    u0,
    dt: float = 0.01,
    rel_step: float = 1e-3,
):
    """Finite-difference sensitivity of the next Euler state to each inertial
    parameter: returns (S [P, nx], labels) with S_p = (x+_p - x+_0)/step_p.

    One batched call on the params' device replaces the reference's 10*nq
    serial integrations (`evaluate_model_sensibility.py:97-121`)."""
    batch, labels = perturbed_params_batch(params, rel_step=rel_step)
    kw = dict(dtype=params.mass.dtype, device=params.mass.device)
    x0 = torch.as_tensor(np.asarray(x0), **kw)
    u0 = torch.as_tensor(np.asarray(u0), **kw)
    xs = torch.func.vmap(
        lambda p: integrator.euler_step(model, p, x0, u0, dt))(batch)
    S = (xs[1:] - xs[0][None]) / rel_step
    return S.cpu().numpy(), labels[1:]


def sensitivity_svd(S: np.ndarray):
    """SVD spectrum of the sensitivity matrix (the reference's analysis
    output, `evaluate_model_sensibility.py:122`)."""
    U, s, Vt = np.linalg.svd(S, full_matrices=False)
    return U, s, Vt
