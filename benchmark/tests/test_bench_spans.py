"""The program spans' reduction (`program_spans`): on a synthetic profile
each launch goes to the spans open at its host launch call (found by
correlation id), the idle parts and the part outside every span sum to the
window's idle as `tracing.summarize` finds it, and spans change nothing
else the summary gives; the span readers read None without the program's
spans; and every span reader runs in the CPU traced run of a shrunk
cell."""

from types import SimpleNamespace

import pytest
import torch

import harness
import program_spans
import tracing
from _small_cells import SMALL, load, run_small
from metrics_context import Context

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
SPAN_METRICS = [m["name"] for m in load("tiago-full-t20-batch4096").per_layer
                if m["name"].split(".")[0] in ("riccati", "cost_packs")
                or m["name"] in ("fddp.launches.batch",
                                 "fddp.sync_wait_ms.batch",
                                 "fddp.idle_ms.batch")]


class _Event:
    def __init__(self, name, kind, a, b, corr=0, user=False, thread=1):
        self._v = (name, kind, a, b - a, corr, user, thread)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]

    def start_thread_id(self):
        return self._v[6]


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


SPANS = [("fddp.solve", 100, 900), ("fddp.riccati", 200, 400),
         ("fddp.costs", 500, 600), ("fddp.sync", 700, 750)]
# (runtime call, its start, the device event, its interval); correlation
# ids 1..6 in order, the last launch's call not in the trace
LAUNCHES = [("cudaLaunchKernel", 50, "k_a", 60, 80),
            ("cudaLaunchKernel", 250, "reduce_kernel", 300, 350),
            ("cudaLaunchKernel", 260, "reduce_kernel", 350, 420),
            ("cudaLaunchKernel", 550, "k_b", 560, 640),
            ("cudaMemcpyAsync", 720, "Memcpy DtoH (Device -> Pinned)", 760,
             770),
            ("cudaLaunchKernel", 800, "k_c", 810, 820)]


def _events(spans=True):
    ev = [_Event(tracing.WINDOW_SPAN, CPU, 0, 1000, user=True),
          _Event(tracing.WINDOW_SPAN, CUDA, 0, 1000, user=True)]
    if spans:
        ev += [_Event(n, CPU, a, b, user=True) for n, a, b in SPANS]
        ev += [_Event("fddp.riccati", CUDA, 300, 420, user=True),  # mirror
               _Event("other_thread", CPU, 0, 1000, user=True, thread=2)]
    for corr, (call, t, kernel, a, b) in enumerate(LAUNCHES, 1):
        if corr < len(LAUNCHES):
            ev.append(_Event(call, CPU, t, t + 5, corr=corr))
        ev.append(_Event(kernel, CUDA, a, b, corr=corr))
    # an aten op whose own correlation id equals a launch's
    ev.append(_Event("aten::mm", CPU, 120, 130, corr=2))
    return ev


SOLVE = ("fddp.solve",)


def test_launches_go_to_the_spans_of_their_launch_call():
    s = program_spans.reduce(_prof(_events()))
    assert s.launches == {(): 1, SOLVE + ("fddp.riccati",): 2,
                                SOLVE + ("fddp.costs",): 1,
                                SOLVE + ("fddp.sync",): 1, None: 1}
    assert s.device_s[SOLVE + ("fddp.riccati",)] == pytest.approx(
        120e-9)
    assert s.device_s[SOLVE + ("fddp.costs",)] == pytest.approx(80e-9)
    assert set(s.spans) == {n for n, _, _ in SPANS}
    assert s.spans["fddp.sync"] == [pytest.approx((700e-9, 750e-9))]


def test_idle_parts_sum_to_the_window_idle():
    prof = _prof(_events())
    s = program_spans.reduce(prof)
    want = {(): 180, SOLVE: 370, SOLVE + ("fddp.riccati",): 100,
            SOLVE + ("fddp.costs",): 60, SOLVE + ("fddp.sync",): 50}
    assert s.idle_by_stack_s == pytest.approx({k: v * 1e-9
                                               for k, v in want.items()})
    assert sum(s.idle_by_stack_s.values()) == pytest.approx(s.idle_s)
    assert s.idle_s == pytest.approx(tracing.summarize(prof).idle_s)


def test_what_the_reduction_gave_before_is_unchanged():
    with_spans = tracing.summarize(_prof(_events()))
    bare = tracing.summarize(_prof(_events(spans=False)))
    for f in ("window_s", "busy_s", "kernel_s", "kernel_launches"):
        assert getattr(with_spans, f) == getattr(bare, f), f
    assert (with_spans.breakdown["device_ops"]
            == bare.breakdown["device_ops"])
    assert set(with_spans.breakdown) == {"device_ops", "idle_gaps"}
    bare = program_spans.reduce(_prof(_events(spans=False)))
    assert bare.spans == {} and bare.launches == {(): 5, None: 1}


def _ctx(summary, units=2, profile=None):
    return Context(cell=None, loop=SimpleNamespace(unit_name="solve"),
                   t0=0.0, t1=1.0, setup_s=0.0, counters={"units": units},
                   trace=summary, profile=profile)


def _read(metric, prof):
    """`metric` as `harness.run_cell` reads it: the profile `prof` and its
    summary on the context."""
    return harness.reader(metric)(_ctx(tracing.summarize(prof), profile=prof))


def test_of_context_reduces_the_profile_on_the_context_once(monkeypatch):
    prof = _prof(_events())
    calls = []
    reduce = program_spans.reduce
    monkeypatch.setattr(program_spans, "reduce",
                        lambda p: calls.append(p) or reduce(p))
    ctx = _ctx(tracing.summarize(prof), profile=prof)
    s = program_spans.of_context(ctx, "fddp.riccati", "solve")
    assert calls == [prof]
    assert s.launches == reduce(prof).launches
    assert program_spans.of_context(ctx, "fddp.costs", "solve") is s
    assert program_spans.of_context(ctx, "no.such.span", "solve") is None
    assert program_spans.of_context(ctx, "fddp.riccati", "tick") is None
    assert calls == [prof]  # once for the context
    other = _ctx(tracing.summarize(prof), profile=prof)
    assert program_spans.of_context(other, "fddp.riccati", "solve") is not s
    assert len(calls) == 2


def test_span_readers_per_solve():
    prof = _prof(_events())
    read = lambda m: _read(m, prof)
    assert read("riccati.launches.batch") == 1.0
    assert read("cost_packs.launches.batch") == 0.5
    assert read("fddp.launches.batch") == 2.0
    assert read("riccati.device_ms.batch") == pytest.approx(60e-6)
    assert read("riccati.idle_ms.batch") == pytest.approx(50e-6)
    assert read("cost_packs.idle_ms.batch") == pytest.approx(30e-6)
    assert read("fddp.idle_ms.batch") == pytest.approx(210e-6)
    assert read("fddp.sync_wait_ms.batch") == pytest.approx(25e-6)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_reader_reads_none_without_program_spans(metric):
    assert len(SPAN_METRICS) == 9
    assert _read(metric, _prof(_events(spans=False))) is None
    assert harness.reader(metric)(_ctx(None)) is None
    # a traced context whose profile is None
    summary = tracing.summarize(_prof(_events()))
    assert harness.reader(metric)(_ctx(summary)) is None


def test_span_readers_in_a_cpu_traced_run(monkeypatch):
    kept = []
    reduce = program_spans.reduce
    monkeypatch.setattr(program_spans, "reduce",
                        lambda prof: kept.append(reduce(prof)) or kept[-1])
    name = "panda-t20-batch4096"
    out = run_small(name, trace=True)
    s, m = kept[0], out["metrics"]
    units = out["attempted"] // SMALL[name]["batch"]
    assert set(SPAN_METRICS) <= set(m)
    for k in ("riccati.launches.batch", "cost_packs.launches.batch",
              "fddp.launches.batch", "riccati.device_ms.batch",
              "cost_packs.device_ms.batch"):
        assert m[k]["value"] == 0, k  # no device events on the CPU
    assert len(s.spans["fddp.solve"]) == units
    assert (len(s.spans["fddp.sync"]) / units
            == m["fddp.host_syncs.batch"]["value"])
    assert len(kept) == 1  # once for all the readers of the run
    outside = sum(v for k, v in s.idle_by_stack_s.items()
                  if "fddp.solve" not in k)
    parts = sum(m[k]["value"] for k in ("riccati.idle_ms.batch",
                                        "cost_packs.idle_ms.batch",
                                        "fddp.idle_ms.batch"))
    assert parts + 1e3 * outside / units == pytest.approx(
        1e3 * s.idle_s / units, rel=1e-9)
