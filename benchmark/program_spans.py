"""The program's spans in a traced run: device launches, their device time
and the card's idle per stack of the program's `record_function` ranges,
and the span readers' figures per tick or solve.

Program spans are the host user annotations other than the harness's
window ("bench.window"), on the window's thread (e.g. "fddp.solve" >
"fddp.riccati"). Each device event of the window (kernel, copy, set) is
put down to the stack of spans open when the host call that launched it
ran: the runtime call (`cudaLaunchKernel`, `cudaMemcpyAsync`, ...) that
carries the event's CUPTI correlation id. Each idle interval of the window
is split over the stacks open along it. A stack is a tuple of span names,
outermost first, () outside every span; a launch whose runtime call is not
in the trace goes to None. Busy time and idle gaps are found as
`tracing.summarize` finds them, so the idle parts sum to its idle.

The harness hands each reader the finished profile on the context
(`metrics_context.Context.profile`), which reduces it once per run
(`Context.spans`). A program without spans, or a run without a profile,
reads None.
"""

from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass, field

import torch

from tracing import WINDOW_SPAN


@dataclass
class SpanSummary:
    idle_s: float
    # program span name -> [(start, end)] s from the window's start
    spans: dict = field(default_factory=dict)
    # stack of program spans -> device launches, their device s, idle s
    launches: dict = field(default_factory=dict)
    device_s: dict = field(default_factory=dict)
    idle_by_stack_s: dict = field(default_factory=dict)


def _stacks(spans, t0, t1):
    """[(start, stack)] tiling [t0, t1]: from each start on, `stack` is the
    tuple of program spans open, outermost first. `spans` [(a, b, name)]
    nest (one host thread); a span is cut to its parent's end."""
    out, open_ = [(t0, ())], []

    def mark(t):
        stack = tuple(n for _, n in open_)
        if out[-1][0] == t:
            out[-1] = (t, stack)
        else:
            out.append((t, stack))

    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        while open_ and open_[-1][0] <= a:
            end = open_.pop()[0]
            mark(end)
        open_.append((min(b, open_[-1][0]) if open_ else b, name))
        mark(a)
    while open_:
        end = open_.pop()[0]
        mark(end)
    return out


def _by_stack(spans, runtime, dev, gaps, t0, t1):
    """(launches, device ns, idle ns) per stack of program spans: each
    device event (a, b, correlation id) at the stack open at its launch
    call's start (`runtime`: correlation id -> host start; None where not
    found), each idle gap (a, b) split over the stacks open along it."""
    tiles = _stacks(spans, t0, t1)
    starts = [t for t, _ in tiles]
    launches, device, idle = {}, {}, {}
    for a, b, corr in dev:
        launch = runtime.get(corr)
        stack = (None if launch is None
                 else tiles[bisect_right(starts, max(launch, t0)) - 1][1])
        launches[stack] = launches.get(stack, 0) + 1
        device[stack] = device.get(stack, 0) + (b - a)
    for a, b in gaps:
        i = bisect_right(starts, a) - 1
        while i < len(tiles) and tiles[i][0] < b:
            end = tiles[i + 1][0] if i + 1 < len(tiles) else t1
            part = min(b, end) - max(a, tiles[i][0])
            if part > 0:
                stack = tiles[i][1]
                idle[stack] = idle.get(stack, 0) + part
            i += 1
    return launches, device, idle


def reduce(prof) -> SpanSummary:
    """The program's spans of a finished profile, and launches, device time
    and idle per stack of them, over the harness's window."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    windows, thread, marks, runtime, dev = [], None, [], {}, []
    for e in prof.profiler.kineto_results.events():
        kind = e.device_type()
        if kind == cuda:
            name = e.name()
            if name == WINDOW_SPAN:
                a = e.start_ns()
                windows.append((a, a + e.duration_ns()))
            elif not e.is_user_annotation():
                a = e.start_ns()
                dev.append((a, a + e.duration_ns(), e.correlation_id()))
        elif kind == cpu:
            name = e.name()
            if name == WINDOW_SPAN:
                a = e.start_ns()
                windows.append((a, a + e.duration_ns()))
                if thread is None:
                    thread = e.start_thread_id()
            elif e.is_user_annotation():
                a = e.start_ns()
                marks.append((a, a + e.duration_ns(), name,
                              e.start_thread_id()))
            elif name.startswith("cu"):  # a CUDA API call (cudaLaunchKernel)
                runtime.setdefault(e.correlation_id(), e.start_ns())
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    t0, t1 = min(w[0] for w in windows), max(w[1] for w in windows)
    spans = [(max(a, t0), min(b, t1), name) for a, b, name, th in marks
             if th == thread and b > t0 and a < t1]
    dev = sorted((max(a, t0), min(b, t1), c) for a, b, c in dev
                 if b > t0 and a < t1)
    busy, gaps, cur_a, cur_b = 0, [], None, t0
    for a, b, _ in dev:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            if a > cur_b:
                gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if t1 > cur_b:
        gaps.append((cur_b, t1))
    per_span = {}
    for a, b, name in spans:
        per_span.setdefault(name, []).append(((a - t0) * 1e-9,
                                              (b - t0) * 1e-9))
    n, device, idle = _by_stack(spans, runtime, dev, gaps, t0, t1)
    return SpanSummary(
        idle_s=(t1 - t0 - busy) * 1e-9, spans=per_span, launches=n,
        device_s={k: v * 1e-9 for k, v in device.items()},
        idle_by_stack_s={k: v * 1e-9 for k, v in idle.items()})


def of_context(ctx, name: str, unit: str):
    """The run's SpanSummary where it is a traced run of the loop `unit`
    in which the program recorded the span `name`, else None."""
    if ctx.profile is None or ctx.unit != unit:
        return None
    s = ctx.spans
    return s if name in s.spans else None


def _per_unit(ctx, table: dict, keep, scale: float = 1.0):
    return scale * sum(v for k, v in table.items()
                       if k is not None and keep(k)) / ctx.units


def launches(ctx, name: str, unit: str):
    """Device launches per unit whose host call ran inside the span `name`
    (spans nested in it included)."""
    s = of_context(ctx, name, unit)
    return None if s is None else _per_unit(ctx, s.launches,
                                            lambda k: name in k)


def device_ms(ctx, name: str, unit: str):
    """Device ms per unit of the launches `launches` counts."""
    s = of_context(ctx, name, unit)
    return None if s is None else _per_unit(ctx, s.device_s,
                                            lambda k: name in k, 1e3)


def idle_ms(ctx, names: tuple, unit: str):
    """Card idle ms per unit while one of `names` is the innermost program
    span."""
    s = of_context(ctx, names[0], unit)
    return None if s is None else _per_unit(
        ctx, s.idle_by_stack_s, lambda k: bool(k) and k[-1] in names, 1e3)


def wall_ms(ctx, name: str, unit: str):
    """Host ms per unit inside the spans `name`."""
    s = of_context(ctx, name, unit)
    return None if s is None else 1e3 * sum(
        b - a for a, b in s.spans[name]) / ctx.units
