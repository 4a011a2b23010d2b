"""The traced slice: ``torch.profiler`` over the card's activity, kept in
memory and reduced to the device's busy time, its operations by name and
its idle gaps by what the harness's host spans were doing.

Every device operation counts, whatever its name (kernels, copies, sets),
so a kernel that a later change adds or renames is still counted.  The
host spans are the harness's own (``SPANS``), recorded as profiler
annotations on the same clock as the device's operations."""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time

import torch

#: the harness's host spans, by what it was doing
SPANS = ("bench.submit", "bench.advance", "bench.retire")
#: entries of each list in the breakdown
TOP = 10


@dataclasses.dataclass
class Summary:
    """What the traced slice showed."""

    window_s: float              # the traced slice's length
    busy_s: float                # union of every device operation
    device_s: float              # summed device time of every operation
    ops: list[tuple[str, float]]          # seconds by name, largest first
    idle: list[tuple[str, float]]         # idle seconds by host span


class Tracer:
    """``with Tracer(on) as t:`` profiles the body when ``on`` (a card);
    ``t.span(name)`` marks a host span; ``t.summary`` is set on exit."""

    def __init__(self, on: bool):
        self.on = on
        self.summary: Summary | None = None
        self._prof = None

    def __enter__(self) -> "Tracer":
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._t0 = time.time_ns()
        return self

    def span(self, name: str):
        """A host span in the trace (nothing when not tracing)."""
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def __exit__(self, *exc) -> None:
        t1 = time.time_ns()
        if self._prof is None:
            return
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarize(
                self._prof.profiler.kineto_results.events(), self._t0, t1)
        self._prof = None


def _merge(iv: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events, t0: int, t1: int) -> Summary:
    """Reduce kineto ``events`` to a :class:`Summary` of ``[t0, t1]`` ns
    (the profiler's clock, which is the host's wall clock)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev: list[tuple[int, int]] = []
    by_name: dict[str, int] = {}
    host: list[tuple[int, int, str]] = []
    total = 0
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name in SPANS or e.is_user_annotation():
                continue             # a host span drawn on the device row
            a = e.start_ns()
            b = a + e.duration_ns()
            a, b = max(a, t0), min(b, t1)
            if b <= a:
                continue
            dev.append((a, b))
            by_name[name] = by_name.get(name, 0) + (b - a)
            total += b - a
        elif name in SPANS:
            a = e.start_ns()
            host.append((a, a + e.duration_ns(), name))
    busy = _merge(dev)
    host.sort()
    starts = [h[0] for h in host]
    idle: dict[str, int] = {}
    edge = t0
    for a, b in [*busy, (t1, t1)]:
        if a > edge:
            mid = (edge + a) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = (host[i][2].split(".", 1)[1]
                     if i >= 0 and host[i][1] >= mid else "other")
            idle[label] = idle.get(label, 0) + (a - edge)
        edge = max(edge, b)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return Summary(window_s=(t1 - t0) / 1e9,
                   busy_s=sum(b - a for a, b in busy) / 1e9,
                   device_s=total / 1e9,
                   ops=[(n, ns / 1e9) for n, ns in ops],
                   idle=[(n, ns / 1e9) for n, ns in
                         sorted(idle.items(), key=lambda kv: -kv[1])][:TOP])
