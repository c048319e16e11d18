"""The port's model-parameter sensitivity sweep (`parallel/sensitivity.py`)
vs the JAX package, f64 on the CPU, on the Panda: the perturbed params
batch (B = 10 nj + 1 = 71 rows, its labels and every row's fields), the
next-state sensitivity matrix at 1e-9, and its SVD spectrum."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from agimus_controller_tpu.models.panda import load_panda as jax_load_panda
from agimus_controller_tpu.parallel import sensitivity as jsens
from agimus_controller_tpu_torch.models.model import ModelParams
from agimus_controller_tpu_torch.models.panda import PANDA_Q_READY, load_panda
from agimus_controller_tpu_torch.parallel import (
    next_state_sensitivity,
    perturbed_params_batch,
    sensitivity_svd,
)


@pytest.fixture(scope="module")
def panda():
    jm, jp = jax_load_panda(dtype=np.float64)
    pm, pp = load_panda(dtype=torch.float64, device="cpu")
    rng = np.random.default_rng(0)
    x0 = np.concatenate([PANDA_Q_READY + rng.normal(size=7) * 0.1,
                         rng.normal(size=7) * 0.3])
    u0 = rng.normal(size=7) * 2.0
    return jm, jp, pm, pp, x0, u0


@pytest.mark.parametrize("field", ModelParams._fields)
def test_perturbed_params_batch_matches_jax(panda, field):
    _, jp, _, pp, _, _ = panda
    got, labels = perturbed_params_batch(pp)
    want, jlabels = jsens.perturbed_params_batch(jp)
    assert labels == jlabels and len(labels) == 71
    g, w = getattr(got, field), np.asarray(getattr(want, field))
    assert tuple(g.shape) == w.shape and g.shape[0] == 71
    np.testing.assert_array_equal(g.numpy(), w)


def test_perturbed_rows_perturb_one_parameter(panda):
    _, _, _, pp, _, _ = panda
    got, labels = perturbed_params_batch(pp)
    for r in range(1, 71):
        changed = [f for f in ("inertia", "com", "mass")
                   if not torch.equal(getattr(got, f)[r], getattr(pp, f))]
        kind = {"I": "inertia", "c": "com", "m": "mass"}[
            labels[r].split("_")[1][0]]
        assert changed == [kind], labels[r]


@pytest.fixture(scope="module")
def sensitivity(panda):
    jm, jp, pm, pp, x0, u0 = panda
    got = next_state_sensitivity(pm, pp, x0, u0)
    want = jsens.next_state_sensitivity(jm, jp, jnp.asarray(x0),
                                        jnp.asarray(u0))
    return got, want


def test_next_state_sensitivity_matches_jax(sensitivity):
    (S, labels), (Sj, jlabels) = sensitivity
    assert labels == jlabels and S.shape == (70, 14)
    np.testing.assert_allclose(S, Sj, rtol=0, atol=1e-9)
    assert np.abs(S).max() > 1e-3  # the sweep sees the parameters


def test_sensitivity_svd_matches_jax(sensitivity):
    (S, _), (Sj, _) = sensitivity
    U, s, Vt = sensitivity_svd(S)
    _, sj, _ = jsens.sensitivity_svd(Sj)
    np.testing.assert_allclose(s, sj, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose((U * s) @ Vt, S, rtol=0, atol=1e-12)
