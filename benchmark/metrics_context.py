"""What a metric reader reads: the run's window, counters, trace and
profile."""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import cached_property

import program_spans
import roofline


@dataclass
class Context:
    cell: object  # harness.load_cell's namespace
    loop: object  # traffic.Loop after the window
    t0: float  # the window on the host clock, s
    t1: float
    setup_s: float
    counters: dict = field(default_factory=dict)  # deltas over the window
    trace: object = None  # tracing.TraceSummary of a traced run
    sizes: dict = field(default_factory=dict)  # the loop's sizes(): T, B, nj
    profile: object = None  # the finished torch.profiler.profile, if traced

    @cached_property
    def spans(self):
        """The program's spans in the profile (`program_spans.reduce`),
        reduced once for all the readers of a run."""
        return program_spans.reduce(self.profile)

    @property
    def unit(self) -> str:
        """"tick" or "solve"."""
        return self.loop.unit_name

    @property
    def units(self) -> int:
        return self.counters["units"]

    def per_unit(self, counter: str, unit: str):
        """A counter's delta per tick or solve, None in another loop or
        where the program has no such counter."""
        if self.unit != unit or counter not in self.counters:
            return None
        return self.counters[counter] / self.units

    def per_row(self, counter: str, unit: str):
        if self.unit != unit or counter not in self.counters:
            return None
        return self.counters[counter] / self.counters["rows"]

    def idle_pct(self, unit: str):
        if self.trace is None or self.unit != unit:
            return None
        return 100.0 * self.trace.idle_s / self.trace.window_s

    def other_device_ms(self, unit: str):
        """Device ms per unit of the kernels no file under `kernels/`
        names: the plain-PyTorch numerics."""
        if self.trace is None or self.unit != unit:
            return None
        ours = roofline.kernel_map()
        s = sum(v for k, v in self.trace.kernel_s.items() if k not in ours)
        return 1e3 * s / self.units

    def roofline_pct(self, group: str, unit: str):
        """Share of its roofline of the work of the kernels of `group`:
        the least time of every traced launch over their device time, in
        %; None where none of them ran."""
        if self.trace is None or self.unit != unit:
            return None
        least = spent = 0.0
        for name, m in roofline.kernel_map().items():
            n = self.trace.kernel_launches.get(name, 0)
            if m["group"] != group or n == 0:
                continue
            nodes = roofline.size_expr(m["nodes_per_launch"], self.sizes)
            least += n * roofline.bound_s(m["work"],
                                          self.cell.config["work_ops"],
                                          nodes, self.sizes["nj"])[0]
            spent += self.trace.kernel_s[name]
        return 100.0 * least / spent if spent > 0 else None
