"""The stage kernels' in-kernel ref gather, emulated on the CPU.

K1/K2 read node n's ref row from the wrapper's source table
(`cuda_costs.RefPlan.table`): columns [off, off + ncomp) of a key are
src[(per_node ? t_idx[n] : row) * stride + i], a null src reads 0. This
test reads the table's memory exactly so, in Python, and holds the result
equal (bit for bit) to `gather_node_refs`, the plain versions' gather, on
chip_smoke's five checked specs for refs made by `refs_from_numpy` and for
the tick's ring-row views (`RowLayout.unpack_refs`); checks that float32
refs with contiguous rows are read in place (no torch op), that a float64
or strided ref is converted and still gives the same rows, that a layout
over the table's cap (`chip_smoke.cap_spec`) is read from the rows
gathered once per call, and that the terminal kernels K3/K4 read the
horizon's row.
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import chip_smoke as smoke
from agimus_controller_tpu_torch.models.panda import load_panda
from agimus_controller_tpu_torch.ocp.spec import refs_from_numpy
from agimus_controller_tpu_torch.ops import cuda_costs

CPU = torch.device("cpu")
N = 19
SPECS = ("flagship", "full", "yaml", "vs", "fv")


@pytest.fixture(scope="module")
def panda():
    return load_panda(env_urdf=smoke.ENV_URDF, collision_pairs=smoke.PAIR,
                      dtype=torch.float32, device=CPU)


def emulate_reads(tab, t_idx, width):
    """The ref rows [N, width] the kernel reads through `tab`."""
    out = np.zeros((len(t_idx), max(width, 1)), np.float32)
    for k in range(tab.n):
        e = tab.e[k]
        for n, t in enumerate(t_idx.tolist()):
            for i in range(e.ncomp):
                if e.src is None:
                    continue
                idx = (t if e.per_node else e.row) * e.stride + i
                out[n, e.off + i] = ctypes.c_float.from_address(
                    e.src + 4 * idx).value
    return torch.as_tensor(out)


def expected_rows(k, refs, t_idx):
    return cuda_costs.gather_node_refs(
        k.layout, cuda_costs.with_geom_defaults(k.layout, refs, k.params),
        t_idx, torch.float32)


def table(k, refs):
    return k.plan.table(refs, CPU)


def inputs(spec_name, model):
    spec = smoke.SPECS[spec_name](100, model)
    refs, _, _, _, t_idx = smoke.randomized_inputs(spec, model, N, seed=7,
                                                   device=CPU)
    return spec, refs, t_idx


@pytest.mark.parametrize("view", ["numpy", "tick"])
@pytest.mark.parametrize("spec_name", SPECS)
def test_reads_equal_gather(panda, spec_name, view):
    model, params = panda
    spec, refs, t_idx = inputs(spec_name, model)
    refs = refs_from_numpy({key: v.numpy() for key, v in refs.items()},
                           dtype=torch.float32, device=CPU)
    if view == "tick":
        refs = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_stage(model, params, spec, True, CPU)
    tab, keep = table(k, refs)
    assert tab.n == len(k.layout)
    got = emulate_reads(tab, t_idx, k.width)
    assert torch.equal(got, expected_rows(k, refs, t_idx))
    # float32 refs with contiguous rows are read where they lie
    assert all(any(v.data_ptr() == r.data_ptr() for r in refs.values()
                   if isinstance(r, torch.Tensor)) for v in keep
               if v is not params.geom_rot and v is not params.geom_trans)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("spec_name", SPECS)
def test_tick_views_run_no_torch_op(panda, spec_name):
    model, params = panda
    spec, refs, _ = inputs(spec_name, model)
    views = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_stage(model, params, spec, False, CPU)
    with _CountOps() as mode:
        table(k, views)
    assert mode.ops == []


@pytest.mark.parametrize("change", ["float64", "strided", "scalar"])
def test_converted_refs_give_the_same_rows(panda, change):
    model, params = panda
    spec, refs, t_idx = inputs("full" if change == "scalar" else "vs", model)
    k = cuda_costs.make_cuda_stage(model, params, spec, True, CPU)
    want = expected_rows(k, refs, t_idx)
    refs = dict(refs)
    if change == "float64":
        refs["xref"] = refs["xref"].double()
        refs["wMo_trans:object"] = refs["wMo_trans:object"].double()
    elif change == "strided":  # transposed storage of each rotation
        refs["ee_rot:panda_hand_tcp"] = refs[
            "ee_rot:panda_hand_tcp"].transpose(1, 2).contiguous().transpose(1, 2)
        refs["wMo_rot:object"] = refs["wMo_rot:object"].t().contiguous().t()
        assert not refs["wMo_rot:object"].is_contiguous()
    else:  # a 0-d w_coll, one value for every node
        refs["w_coll"] = torch.tensor(0.75)
        want = expected_rows(k, refs, t_idx)
    tab, keep = table(k, refs)
    assert torch.equal(emulate_reads(tab, t_idx, k.width), want)


@pytest.mark.parametrize("view", ["numpy", "tick"])
def test_layout_over_the_cap_reads_gathered_rows(panda, view):
    """A layout of more than MAX_REFS keys (`chip_smoke.cap_spec`: 25
    running keys) is handed over as one per-node key holding the rows of
    every node time, which the kernels read as the plain gather."""
    model, params = panda
    spec, refs, t_idx = inputs("cap25", model)
    if view == "tick":
        refs = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_stage(model, params, spec, True, CPU)
    assert len(k.layout) == cuda_costs.MAX_REFS + 1
    tab, keep = k.plan.table(refs, CPU)
    assert tab.n == 1 and tab.e[0].per_node == 1
    assert tab.e[0].ncomp == tab.e[0].stride == k.width
    assert keep[0].shape == (spec.horizon + 1, k.width)
    assert torch.equal(emulate_reads(tab, t_idx, k.width),
                       expected_rows(k, refs, t_idx))


@pytest.mark.parametrize("spec_name", SPECS + ("cap25",))
def test_terminal_reads_equal_gather(panda, spec_name):
    """K3/K4 read the row of the horizon through the same table (the
    terminal model's layout: 26 keys on `cap25`)."""
    model, params = panda
    spec, refs, _ = inputs(spec_name, model)
    refs = smoke.tick_views(spec, model, refs)
    k = cuda_costs.make_cuda_terminal(model, params, spec, True, CPU)
    t_idx = torch.full((3,), spec.horizon)
    tab, keep = k.plan.table(refs, CPU)
    over = len(k.layout) > cuda_costs.MAX_REFS
    assert over == (spec_name == "cap25")
    assert tab.n == (1 if over else len(k.layout))
    assert torch.equal(emulate_reads(tab, t_idx, k.width),
                       expected_rows(k, refs, t_idx))
