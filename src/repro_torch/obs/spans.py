"""Host spans inside the port's serving engine, kept in memory.

A :class:`SpanRecorder` records what the engine and its runner were doing
on the host: each span's name, its start and end in ns, its parent (the
span open when it opened), the request id (``rid``) of a request-scoped
span or the slot of a slot-scoped one, and a few small attributes (the
exec group, its core, whether it replayed a graph).  A span opened
without a ``rid`` takes its parent's, so the spans beneath a request's
span carry its id without being handed it.  The stamps are on
``time.time_ns()``, the clock of ``torch.profiler``'s events, so a span
and the device's operations line up; while a profiler is running each
span also opens a ``torch.profiler.record_function`` of its name, so it
shows in the trace.

The recorder is off by default.  Off, :meth:`SpanRecorder.span` costs one
attribute check and returns a shared no-op context: it reads no clock,
allocates nothing and appends nothing.  On, finished spans go into a
buffer of ``capacity`` entries; past it a span is dropped and counted in
:attr:`SpanRecorder.dropped`.  :meth:`SpanRecorder.drain` hands the spans
out when the run ends.

The names the CNN engine records (``serving/cnn.py``,
``dualcore/runtime.py``, ``serving/api.py``), each with its scope:

* ``engine.advance`` (slot): one slot's dispatch, ``DualCoreEngine.advance``;
* ``runner.group`` (rid; group, core, graph): one exec group of one request
  on its core: the ready-event wait, the ``record_stream`` loop, the graph's
  replay (or the eager steps) and the new event's record;
* ``runner.clone_out`` (rid): the last group's clone of ``"out"`` out of
  its lane, inside that group's ``runner.group``;
* ``engine.admit`` (rid): one admission, holding ``runner.load`` (rid: the
  lane's acquire and the input's copy), which holds ``runner.capture``
  (rid) when the lane pool grows (the eager warm run included) and, at a
  measuring runner's first capture, ``runner.balance`` (rid: the search
  for the c-core's SMs), one ``runner.probe`` (rid) in it a count tried;
* ``engine.retire`` (slot): one slot's retirement, holding one
  ``engine.ready_wait`` (rid) around each output's ready-event wait.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import torch

#: spans a recorder keeps by default before it drops and counts
DEFAULT_CAPACITY = 1 << 20


class Span(NamedTuple):
    """One finished span.  ``parent`` is the ``sid`` of the span open when
    this one opened (None at the top); ``rid`` a request-scoped span's
    request, ``slot`` a slot-scoped span's slot."""

    sid: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None = None
    rid: int | None = None
    slot: int | None = None
    group: int | None = None
    core: str | None = None
    graph: bool | None = None

    @property
    def duration_ns(self) -> int:
        """The span's length in ns."""
        return self.end_ns - self.start_ns


class _NoSpan:
    """The shared context of a span not recorded."""

    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    """A span being recorded (``with recorder.span(...)``)."""

    __slots__ = ("rec", "name", "attrs", "sid", "parent", "start", "rf")

    def __init__(self, rec: "SpanRecorder", name: str, attrs: tuple):
        self.rec = rec
        self.name = name
        self.attrs = attrs          # rid, slot, group, core, graph
        self.rf = None

    def __enter__(self) -> "_OpenSpan":
        rec = self.rec
        self.sid = rec._next_sid
        rec._next_sid += 1
        top = rec._stack[-1] if rec._stack else None
        self.parent = None if top is None else top.sid
        if self.attrs[0] is None and top is not None:
            self.attrs = (top.attrs[0], *self.attrs[1:])
        rec._stack.append(self)
        # each stamp just before the annotation's own, which the profiler
        # takes first thing in its callback (its bookkeeping follows)
        self.start = time.time_ns()
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        rec = self.rec
        rec._stack.pop()
        rec._keep(Span(self.sid, self.name, self.start, end, self.parent,
                       *self.attrs))
        return False


class SpanRecorder:
    """Spans in a bounded in-memory buffer (module docstring).

    ``enabled`` may be switched at any time."""

    def __init__(self, enabled: bool = False,
                 capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.enabled = enabled
        self.capacity = capacity
        self.dropped = 0
        self._spans: list[Span] = []
        self._stack: list[_OpenSpan] = []
        self._next_sid = 0

    def span(self, name: str, rid: int | None = None,
             slot: int | None = None, group: int | None = None,
             core: str | None = None, graph: bool | None = None):
        """A context that records the span ``name`` around its body (the
        shared no-op context when the recorder is off)."""
        if not self.enabled:
            return NO_SPAN
        return _OpenSpan(self, name, (rid, slot, group, core, graph))

    def _keep(self, span: Span) -> None:
        if len(self._spans) < self.capacity:
            self._spans.append(span)
        else:
            self.dropped += 1

    def drain(self) -> list[Span]:
        """Hand out the spans held, in the order they ended, and empty the
        buffer (``dropped`` keeps counting)."""
        out, self._spans = self._spans, []
        return out
