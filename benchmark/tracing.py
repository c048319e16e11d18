"""The traced run: `torch.profiler` over whole ticks or solves, and its
reduction to what the per-layer readers read.

The harness marks the traced window with a host span ("bench.window");
device events are every kernel, copy and set on the card. Times are the
profiler's (one clock for host and device).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from roofline import kernel_name

WINDOW_SPAN = "bench.window"
_COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: dict = field(default_factory=dict)  # kernel name -> device s
    kernel_launches: dict = field(default_factory=dict)
    breakdown: dict = field(default_factory=dict)

    @property
    def idle_s(self) -> float:
        return self.window_s - self.busy_s


def profiler():
    """A profiler of host and card activity (not started)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts)


def _span(e):
    return e.start_ns(), e.start_ns() + e.duration_ns()


def summarize(prof, top: int = 10) -> TraceSummary:
    """Reduce a finished profile to the window's busy time, the device
    time and launches per kernel name, and the breakdown: the `top` device
    operations by time and the `top` longest idle gaps, each named by the
    innermost host operation running at its middle."""
    events = list(prof.profiler.kineto_results.events())
    windows = [_span(e) for e in events if e.name() == WINDOW_SPAN]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    t0, t1 = min(w[0] for w in windows), max(w[1] for w in windows)
    dev, host = [], []
    for e in events:
        kind = e.device_type()
        a, b = _span(e)
        if b <= t0 or a >= t1:
            continue
        if kind == torch.autograd.DeviceType.CUDA:
            if e.is_user_annotation() or e.name() == WINDOW_SPAN:
                continue  # a host span's mirror on the device timeline
            dev.append((max(a, t0), min(b, t1), e.name()))
        elif kind == torch.autograd.DeviceType.CPU and e.name() != WINDOW_SPAN:
            host.append((a, b, e.name()))
    dev.sort()
    busy, gaps, cur_a, cur_b = 0, [], None, t0
    for a, b, _ in dev:
        if cur_a is None or a > cur_b:
            if cur_a is not None:
                busy += cur_b - cur_a
            if a > cur_b:
                gaps.append((a - cur_b, cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_a is not None:
        busy += cur_b - cur_a
    if t1 > cur_b:
        gaps.append((t1 - cur_b, cur_b, t1))
    per_name, per_kernel, launches = {}, {}, {}
    for a, b, name in dev:
        per_name[name] = per_name.get(name, 0) + (b - a)
        if not name.startswith(_COPY_PREFIXES):
            k = kernel_name(name)
            per_kernel[k] = per_kernel.get(k, 0) + (b - a)
            launches[k] = launches.get(k, 0) + 1
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    idle = []
    for length, a, b in sorted(gaps, reverse=True)[:top]:
        mid = (a + b) // 2
        inner = [(ha, hn) for ha, hb, hn in host if ha <= mid < hb]
        label = max(inner)[1] if inner else "no host operation"
        idle.append([label, length * 1e-9])
    return TraceSummary(
        window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9,
        kernel_s={k: v * 1e-9 for k, v in per_kernel.items()},
        kernel_launches=launches,
        breakdown={"device_ops": [[n[:200], v * 1e-9] for n, v in ops],
                   "idle_gaps": idle})
