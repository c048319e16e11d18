"""Named spans of the port on the profiler's clock.

A span is a `torch.profiler.record_function` range, so it shares the
profiler's clock with the card's kernels, copies and idle gaps; nesting on
the one host thread gives each span its parent. Spans are on exactly while
a profiler records: otherwise `span` returns one shared no-op context and
costs a single check, where a bare `record_function` would cost more than
a small aten op.
"""

from __future__ import annotations

import contextlib

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range `name` while a profiler runs."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
