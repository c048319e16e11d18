"""The roofline's yardstick: the byte bounds reproduce the figures the
program's kernel table was measured against, and the data files parse."""

import pytest

import roofline


def test_k5b_bound_at_409600_nodes():
    s, kind = roofline.bound_s("step_derivs", "panda-goal", 409_600, 7)
    assert kind == "bytes"
    assert round(s * 1e3, 6) == 0.161395


def test_k1_flagship_bound_at_100_nodes():
    s, kind = roofline.bound_s("stage_derivs", "panda-goal", 100, 7)
    assert kind == "bytes"
    assert round(s * 1e3, 6) == 0.000089


@pytest.mark.parametrize("name", sorted(roofline.kernel_map()))
def test_every_kernel_maps_to_counted_work(name):
    m = roofline.kernel_map()[name]
    nodes = roofline.size_expr(m["nodes_per_launch"], dict(T=100, B=4096))
    assert nodes in (4096, 409_600)
    cfgs = ("panda-goal",) if m["group"] == "stage_kernels" else (
        "panda-goal", "tiago-full")
    for cfg in cfgs:
        s, _ = roofline.bound_s(m["work"], cfg, nodes, 7)
        assert s > 0


@pytest.mark.parametrize("trace_name,name", [
    ("stage_k1_kernel(int, float const*, float const*)", "stage_k1_kernel"),
    ("void ag::step_kernel<7>(int, float*)", "step_kernel"),
    ("void (anonymous namespace)::stage_k1_kernel<7>(int, float const*, "
     "ag::RefTable, int)", "stage_k1_kernel"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::Foo>"
     "(int, at::native::Foo)", "vectorized_elementwise_kernel"),
    ("Memcpy HtoD (Pageable -> Device)", "Memcpy HtoD"),
])
def test_kernel_name(trace_name, name):
    got = roofline.kernel_name(trace_name)
    assert got == name or (name.startswith("Memcpy") and got)


def test_size_expr_refuses_code():
    assert roofline.size_expr("nx + W + nj + 1", dict(nx=14, W=46, nj=7)) == 68
    with pytest.raises(ValueError):
        roofline.size_expr("__import__('os')", {})
