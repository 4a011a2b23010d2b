"""Streaming engine API: requests, tickets, metrics, admission, replay.

Port of the part of ``repro/serving/api.py`` that ``DualCoreEngine``,
``DualMeshEngine`` and ``replay`` need.  ``submit`` enqueues a
:class:`Request` onto the engine's bounded queue and returns a
:class:`Ticket` (raising :class:`QueueFull` at capacity); ``step``
advances the engine by one scheduler slot and returns the requests it
finished as :class:`Completion` objects; ``drain`` steps until no work
remains and returns a :class:`ServeResult`; ``result`` snapshots what has
completed.  Engines never spin a thread: the caller owns the loop.

A completion is stamped when its output's CUDA ready event has fired: the
engine waits on that one event, never on the whole device, so the other
core's work stays in flight and the latency is the request's own.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Any, Protocol, Sequence

import torch


class QueueFull(RuntimeError):
    """``submit`` refused: the engine's bounded request queue is full.

    Backpressure, not an error state: retry after ``step`` has drained
    capacity (``replay`` does exactly that)."""


@dataclasses.dataclass
class Request:
    """One unit of serving work: ``payload`` is a ``(B, P)`` token prompt
    for the LM engine, an ``(N, H, W, 3)`` image batch for the CNN engine.
    ``gen_steps`` is the LM decode budget (total generated tokens; the
    prefill emits the first) and is ignored by the CNN engine.  ``rid`` is
    assigned at submit time."""

    payload: Any
    gen_steps: int = 0
    rid: int | None = None


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Receipt for a submitted request: its id and submission wall-time."""

    rid: int
    submitted_at: float


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock lifecycle of one request (perf_counter timestamps)."""

    rid: int
    submitted_at: float
    started_at: float | None = None     # admitted into the engine
    finished_at: float | None = None    # output materialized

    @property
    def latency_s(self) -> float:
        """Submit-to-finish latency, in seconds."""
        if self.finished_at is None:
            return float("nan")
        return self.finished_at - self.submitted_at


@dataclasses.dataclass
class Completion:
    """A finished request: its ticket, output, and measured lifecycle."""

    ticket: Ticket
    output: Any
    metrics: RequestMetrics


def percentile(xs: Sequence[float], q: float) -> float:
    """Linear-interpolated percentile (numpy semantics)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


@dataclasses.dataclass
class Metrics:
    """Aggregate view over completed requests."""

    requests: list[RequestMetrics] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    @property
    def completed(self) -> int:
        """Requests that reached a terminal status."""
        return len(self.requests)

    def latencies_ms(self) -> list[float]:
        """Latencies of the served requests, in milliseconds."""
        return [m.latency_s * 1e3 for m in self.requests
                if m.finished_at is not None]

    def p50_ms(self) -> float:
        """Median served latency, in milliseconds."""
        return percentile(self.latencies_ms(), 50)

    def p95_ms(self) -> float:
        """95th-percentile served latency, in milliseconds."""
        return percentile(self.latencies_ms(), 95)

    def requests_per_s(self) -> float:
        """Completions per wall-clock second."""
        if not self.wall_s:
            return float("inf") if self.completed else 0.0
        return self.completed / self.wall_s


@dataclasses.dataclass
class ServeResult:
    """What ``drain``/``result`` hand back: outputs in submission order,
    per-request completions, aggregate metrics, engine-specific stats, and
    the engine's per-stage trace (the LM engine's; empty for the CNN
    engine)."""

    outputs: list[Any]
    completions: list[Completion]
    metrics: Metrics
    stats: dict = dataclasses.field(default_factory=dict)
    trace: list = dataclasses.field(default_factory=list)


# --------------------------------------------------------------------------
# admission policies
# --------------------------------------------------------------------------
class AdmissionPolicy(Protocol):
    """Decides, once per ``step``, how many queued requests to admit."""

    def admit(self, *, queued: int, in_flight: int, capacity: int) -> int:
        """Number of requests to move from the queue into the engine; the
        engine clamps it to what is admissible."""
        ...


@dataclasses.dataclass
class GreedyAdmission:
    """Fill all free capacity every step: maximum occupancy."""

    def admit(self, *, queued: int, in_flight: int, capacity: int) -> int:
        """Admit everything the engine has capacity for."""
        return max(0, min(queued, capacity - in_flight))


@dataclasses.dataclass
class FixedRateAdmission:
    """At most ``per_step`` admissions per step; the paper's staggered
    entry (one stream per slot) is ``per_step=1``."""

    per_step: int = 1

    def admit(self, *, queued: int, in_flight: int, capacity: int) -> int:
        """Admit at most ``per_step`` requests per scheduler step."""
        return max(0, min(queued, self.per_step, capacity - in_flight))


# --------------------------------------------------------------------------
# the engine protocol
# --------------------------------------------------------------------------
class EngineBase:
    """Queue / ticket / metrics bookkeeping shared by every engine:
    the bounded pending queue, rid assignment, ticket and metrics stamping
    at submit, completion stamping in :meth:`_finish`, and the
    :meth:`result` snapshot."""

    def __init__(self, *, max_queue: int | None = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue}); "
                             f"a 0-capacity queue could never admit work")
        self.max_queue = max_queue
        self._pending: deque[tuple[Request, Ticket]] = deque()
        self._completions: dict[int, Completion] = {}
        self._order: list[int] = []
        self._metrics: dict[int, RequestMetrics] = {}
        self._next_rid = 0
        self._t0: float | None = None

    def submit(self, request: Request | Any) -> Ticket:
        """Enqueue one request; raises :class:`QueueFull` at the bound."""
        if self.max_queue is not None \
                and len(self._pending) >= self.max_queue:
            raise QueueFull(f"request queue at max_queue={self.max_queue}")
        req = request if isinstance(request, Request) else Request(request)
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        ticket = Ticket(rid=rid, submitted_at=time.perf_counter())
        self._metrics[rid] = RequestMetrics(rid=rid,
                                            submitted_at=ticket.submitted_at)
        self._order.append(rid)
        self._pending.append((req, ticket))
        return ticket

    def _pop_admission(self) -> tuple[Request, Ticket] | None:
        """Pop the next request to admit (FIFO)."""
        return self._pending.popleft() if self._pending else None

    def _start_clock(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def _finish(self, rid: int, output,
                ready: torch.cuda.Event | None = None) -> Completion:
        """Wait for ``output``'s ready event (CUDA; none on the CPU), mark
        it used by the caller's stream, stamp the finish time and file the
        completion."""
        if ready is not None:
            ready.synchronize()
            output.record_stream(torch.cuda.current_stream(output.device))
        m = self._metrics[rid]
        m.finished_at = time.perf_counter()
        c = Completion(ticket=Ticket(rid=rid, submitted_at=m.submitted_at),
                       output=output, metrics=m)
        self._completions[rid] = c
        return c

    def _extra_stats(self, metrics: Metrics) -> dict:
        """Engine-specific stats merged into ``result().stats``."""
        return {}

    def _trace_snapshot(self) -> list:
        """Engine-specific per-stage trace for ``result().trace``."""
        return []

    def result(self) -> ServeResult:
        """Snapshot of everything completed so far, in submission order."""
        wall = ((time.perf_counter() - self._t0) if self._t0 is not None
                else 0.0)
        completions = [self._completions[r] for r in self._order
                       if r in self._completions]
        metrics = Metrics(requests=[c.metrics for c in completions],
                          wall_s=wall)
        stats = {"wall_s": wall}
        stats.update(self._extra_stats(metrics))
        return ServeResult(outputs=[c.output for c in completions],
                           completions=completions, metrics=metrics,
                           stats=stats, trace=self._trace_snapshot())

    def drain(self) -> ServeResult:
        """Step until no queued or in-flight work remains."""
        while self.has_work:
            self.step()
        return self.result()


# --------------------------------------------------------------------------
# arrival-trace driving
# --------------------------------------------------------------------------
def poisson_arrivals(n: int, rate: float = 1.0, seed: int = 0) -> list[int]:
    """Fixed Poisson-ish trace: ``n`` step-indexed arrival times with
    exponential gaps of mean ``1/rate`` steps from a seeded generator (the
    reference's generator and seed, so both give the same trace)."""
    if not rate > 0:
        raise ValueError(f"arrival rate must be > 0 (got {rate}); use an "
                         f"all-zeros arrival list for everything-at-once")
    rng = random.Random(seed)
    t, out = 0.0, []
    for _ in range(n):
        out.append(int(t))
        t += rng.expovariate(rate)
    return out


def replay(engine: EngineBase, requests: Sequence[Request | Any],
           arrivals: Sequence[int] | None = None,
           on_step=None) -> ServeResult:
    """Drive ``engine`` with requests arriving at the given step indices.

    Requests whose arrival step has passed are submitted before each step;
    a :class:`QueueFull` pushes that request to later steps (refused
    requests retry first next step, keeping FIFO order).  ``on_step`` (if
    given) fires after every engine step with the step index.  Returns the
    engine's final result once every request has been served.
    """
    arrivals = list(arrivals) if arrivals is not None else [0] * len(requests)
    if len(arrivals) != len(requests):
        raise ValueError(f"{len(requests)} requests but "
                         f"{len(arrivals)} arrival times")
    order = sorted(range(len(requests)), key=lambda i: arrivals[i])
    refused: list[int] = []
    nxt, step = 0, 0
    while nxt < len(order) or refused or engine.has_work:
        due, refused = refused, []
        while nxt < len(order) and arrivals[order[nxt]] <= step:
            due.append(order[nxt])
            nxt += 1
        for i in due:
            try:
                engine.submit(requests[i])
            except QueueFull:
                refused.append(i)
        engine.step()
        if on_step is not None:
            on_step(step)
        step += 1
    return engine.result()
