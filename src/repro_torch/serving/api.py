"""Streaming engine API: requests, tickets, metrics, admission, replay.

Port of ``repro/serving/api.py``.  ``submit`` enqueues a :class:`Request`
onto the engine's bounded queue and returns a :class:`Ticket` (raising
:class:`QueueFull` at capacity); ``step`` advances the engine by one
scheduler slot and returns the requests it finished as :class:`Completion`
objects; ``drain`` steps until no work remains and returns a
:class:`ServeResult`; ``result`` snapshots what has completed.  Engines
never spin a thread: the caller owns the loop.

Requests carry a ``model`` tag (the fleet routes on it and
:meth:`Metrics.by_model` breaks latencies down by it), a ``deadline`` and
a ``priority``.  Admission policies decide how many queued requests enter
a step and, with ``select``, which ones (:class:`DeadlineAdmission`,
:class:`PriorityAdmission`); :class:`ShedPolicy` drops queued requests
already past their deadline as ``status="shed"`` completions.

A completion is stamped when its output's CUDA ready event has fired: the
engine waits on that one event, never on the whole device, so the other
core's work stays in flight and the latency is the request's own.
"""
from __future__ import annotations

import dataclasses
import random
import time
from collections import deque
from typing import Any, Protocol, Sequence, runtime_checkable

import torch

from repro_torch.obs import Registry, SpanRecorder


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
    assigned at submit time.  ``model`` names the network the request
    targets; ``deadline`` (any comparable: a slot index, a perf_counter
    time) orders :class:`DeadlineAdmission`, ``priority`` (higher is more
    urgent) :class:`PriorityAdmission`."""

    payload: Any
    gen_steps: int = 0
    rid: int | None = None
    model: str | None = None
    deadline: float | None = None
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class Ticket:
    """Receipt for a submitted request: its id and submission wall-time."""

    rid: int
    submitted_at: float


#: terminal request states: served / dropped past its deadline by a
#: ShedPolicy / lost with no surviving pool / served after a pool crash
STATUSES = ("ok", "shed", "failed", "recovered")


@dataclasses.dataclass
class RequestMetrics:
    """Wall-clock lifecycle of one request (perf_counter timestamps)."""

    rid: int
    submitted_at: float
    started_at: float | None = None     # admitted into the engine
    finished_at: float | None = None    # output materialized
    model: str | None = None            # Request.model
    status: str = "ok"                  # one of STATUSES
    deadline: float | None = None       # Request.deadline
    slo_ok: bool = True                 # finished within its deadline

    @property
    def wait_s(self) -> float:
        """Queue wait before admission, in seconds."""
        return (self.started_at or self.submitted_at) - self.submitted_at

    @property
    def service_s(self) -> float:
        """Admission-to-finish service time, in seconds."""
        if self.finished_at is None or self.started_at is None:
            return float("nan")
        return self.finished_at - self.started_at

    @property
    def latency_s(self) -> float:
        """Submit-to-finish latency, in seconds."""
        if self.finished_at is None:
            return float("nan")
        return self.finished_at - self.submitted_at


@dataclasses.dataclass
class Completion:
    """A finished request: its ticket, output, and measured lifecycle.
    ``output`` is None for a shed or failed request."""

    ticket: Ticket
    output: Any
    metrics: RequestMetrics

    @property
    def status(self) -> str:
        """Terminal status of the request."""
        return self.metrics.status


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
    slots_observed: int = 0      # engine slots (or router steps) elapsed

    @property
    def completed(self) -> int:
        """Requests that reached a terminal status."""
        return len(self.requests)

    def latencies_ms(self, model: str | None = None) -> list[float]:
        """Latencies of the served (ok or recovered) requests, optionally
        of one model, in milliseconds."""
        return [m.latency_s * 1e3 for m in self.requests
                if m.finished_at is not None
                and m.status in ("ok", "recovered")
                and (model is None or m.model == model)]

    def count(self, status: str) -> int:
        """Completions with the given terminal status."""
        return sum(1 for m in self.requests if m.status == status)

    def goodput(self) -> int:
        """Served requests that met their deadline (none set = met)."""
        return sum(1 for m in self.requests
                   if m.status in ("ok", "recovered") and m.slo_ok)

    def goodput_fps(self) -> float:
        """Within-deadline completions per wall-clock second."""
        return self.goodput() / self.wall_s if self.wall_s else 0.0

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

    def models(self) -> list[str]:
        """Distinct request model tags, in first-seen order."""
        seen: dict[str, None] = {}
        for m in self.requests:
            if m.model is not None:
                seen.setdefault(m.model, None)
        return list(seen)

    def by_model(self) -> dict[str, dict]:
        """Per model tag: completed count, p50/p95 latency and served
        requests a second over the shared wall clock (None / 0.0 where
        nothing was served, so the dict stays valid JSON)."""
        out: dict[str, dict] = {}
        for model in self.models():
            lats = self.latencies_ms(model)
            out[model] = {
                "completed": len(lats),
                "p50_ms": round(percentile(lats, 50), 3) if lats else None,
                "p95_ms": round(percentile(lats, 95), 3) if lats else None,
                "requests_per_s": round(len(lats) / self.wall_s, 3)
                if self.wall_s else 0.0,
            }
            shed = sum(1 for m in self.requests
                       if m.model == model and m.status == "shed")
            if shed:
                out[model]["shed"] = shed
        return out

    def summary(self) -> dict:
        """Aggregate snapshot, valid JSON also when nothing completed."""
        lats = self.latencies_ms()
        out = {"completed": self.completed,
               "wall_s": round(self.wall_s, 6),
               "slots_observed": self.slots_observed,
               "requests_per_s": round(len(lats) / self.wall_s, 3)
               if self.wall_s else 0.0,
               "goodput_fps": round(self.goodput_fps(), 3),
               "shed": self.count("shed"),
               "failed": self.count("failed"),
               "recovered": self.count("recovered"),
               "p50_ms": round(percentile(lats, 50), 3) if lats else None,
               "p95_ms": round(percentile(lats, 95), 3) if lats else None}
        per_model = self.by_model()
        if per_model:
            out["per_model"] = per_model
        return out


class MetricsWindow:
    """Sliding window over the last ``size`` request completions: the
    recent per-model completion share, shed rate and p95 latency."""

    def __init__(self, size: int = 64):
        """Create a window keeping the most recent ``size`` completions."""
        if size < 1:
            raise ValueError(f"window size must be >= 1 (got {size})")
        self.size = size
        self._buf: deque[RequestMetrics] = deque(maxlen=size)

    def __len__(self) -> int:
        """Number of completions currently held (<= ``size``)."""
        return len(self._buf)

    def observe(self, completions: Sequence[Completion]) -> None:
        """Absorb one step's completions (oldest entries fall out)."""
        for c in completions:
            self._buf.append(c.metrics)

    def clear(self) -> None:
        """Forget everything."""
        self._buf.clear()

    def models(self) -> list[str]:
        """Distinct model tags in the window, in first-seen order."""
        seen: dict[str, None] = {}
        for m in self._buf:
            if m.model is not None:
                seen.setdefault(m.model, None)
        return list(seen)

    def stats(self, model: str | None = None) -> dict:
        """``{"n", "served", "shed", "shed_rate", "p95_ms"}`` over the
        window, optionally of one model (``p95_ms`` None with nothing
        served)."""
        ms = [m for m in self._buf
              if model is None or m.model == model]
        lats = [m.latency_s * 1e3 for m in ms
                if m.finished_at is not None
                and m.status in ("ok", "recovered")]
        shed = sum(1 for m in ms if m.status == "shed")
        return {
            "n": len(ms),
            "served": len(lats),
            "shed": shed,
            "shed_rate": shed / len(ms) if ms else 0.0,
            "p95_ms": percentile(lats, 95) if lats else None,
        }

    def by_model(self) -> dict[str, dict]:
        """Per-model :meth:`stats`, keyed by model tag."""
        return {m: self.stats(m) for m in self.models()}


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
    """Decides, once per ``step``, how many queued requests to admit.  A
    policy may also define ``select(pending) -> int``, the index of the
    queued request to admit next (otherwise FIFO)."""

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


@dataclasses.dataclass
class DeadlineAdmission:
    """Earliest deadline first (None deadlines last, FIFO among
    themselves); as many per step as :class:`FixedRateAdmission`."""

    per_step: int = 1

    def admit(self, *, queued: int, in_flight: int, capacity: int) -> int:
        """Admit at most ``per_step`` requests per scheduler step."""
        return max(0, min(queued, self.per_step, capacity - in_flight))

    def select(self, pending: Sequence[Request]) -> int:
        """Select the earliest-deadline pending request."""
        return min(range(len(pending)),
                   key=lambda i: (pending[i].deadline is None,
                                  pending[i].deadline
                                  if pending[i].deadline is not None
                                  else 0.0, i))


@dataclasses.dataclass
class PriorityAdmission:
    """Highest ``Request.priority`` first, FIFO within a priority."""

    per_step: int = 1

    def admit(self, *, queued: int, in_flight: int, capacity: int) -> int:
        """Admit at most ``per_step`` requests per scheduler step."""
        return max(0, min(queued, self.per_step, capacity - in_flight))

    def select(self, pending: Sequence[Request]) -> int:
        """Select the highest-priority pending request."""
        return min(range(len(pending)),
                   key=lambda i: (-pending[i].priority, i))


@dataclasses.dataclass
class ShedPolicy:
    """Drop queued requests already past their deadline instead of
    serving them late.

    ``inner`` (default ``FixedRateAdmission(1)``) decides how many and
    which.  Engines sweep the queue before every dispatch
    (``EngineBase.shed_expired``; the fleet executor passes its slot) and
    re-check the selected request at admission.  A shed request completes
    with ``status="shed"`` and no output.  ``clock="slot"`` compares
    deadlines with the scheduler slot (deterministic, so a run replays
    with the same shed set); ``clock="wall"`` with ``time.perf_counter()``,
    and then ``slo_s`` stamps a deadline of ``submit + slo_s`` on requests
    that carry none."""

    inner: AdmissionPolicy | None = None
    slo_s: float | None = None
    clock: str = "slot"

    sheds = True        # engines detect shedding support via this attr

    def __post_init__(self):
        if self.clock not in ("slot", "wall"):
            raise ValueError(f"ShedPolicy clock must be 'slot' or 'wall' "
                             f"(got {self.clock!r})")
        if self.slo_s is not None:
            if not self.slo_s > 0:
                raise ValueError(f"slo_s must be > 0 (got {self.slo_s})")
            if self.clock != "wall":
                raise ValueError("slo_s auto-stamps wall-clock deadlines; "
                                 "with clock='slot' set Request.deadline "
                                 "to a slot index explicitly")
        if self.inner is None:
            self.inner = FixedRateAdmission(1)

    def now(self, slot_clock: float) -> float:
        """Current time in the policy's clock domain."""
        return (time.perf_counter() if self.clock == "wall"
                else float(slot_clock))

    def expired(self, deadline: float | None, now: float) -> bool:
        """True when ``deadline`` has passed at ``now``."""
        return deadline is not None and now > deadline

    def admit(self, *, queued: int, in_flight: int, capacity: int) -> int:
        """Delegate the how-many decision to the inner policy."""
        return self.inner.admit(queued=queued, in_flight=in_flight,
                                capacity=capacity)

    def select(self, pending: Sequence[Request]) -> int:
        """Delegate selection to the inner policy (FIFO default)."""
        sel = getattr(self.inner, "select", None)
        return 0 if sel is None else int(sel(pending))


# --------------------------------------------------------------------------
# the engine protocol
# --------------------------------------------------------------------------
@runtime_checkable
class Engine(Protocol):
    """The shared serving surface (module docstring): what every engine,
    the CNN's, the LM's and the fleet's, offers its caller."""

    def submit(self, request: Request | Any) -> Ticket:
        """Enqueue one request and return its ticket."""
        ...

    def step(self) -> list[Completion]:
        """Advance the pipeline one slot; return newly finished work."""
        ...

    def drain(self) -> ServeResult:
        """Step until idle, then return the full result."""
        ...

    def result(self) -> ServeResult:
        """Snapshot of completions and metrics so far."""
        ...

    @property
    def has_work(self) -> bool:
        """True while any queued or in-flight work remains."""
        ...


class EngineBase:
    """Queue / ticket / metrics bookkeeping shared by every engine:
    the bounded pending queue, rid assignment, ticket and metrics stamping
    at submit, admission order and shedding, completion stamping in
    :meth:`_finish`, and the :meth:`result` snapshot.

    ``obs`` is the engine's :class:`~repro_torch.obs.Registry` and
    ``spans`` its :class:`~repro_torch.obs.SpanRecorder`; both default to
    disabled instances, so an engine records nothing unless asked."""

    def __init__(self, *, max_queue: int | None = None,
                 obs: Registry | None = None,
                 spans: SpanRecorder | None = None):
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1 (got {max_queue}); "
                             f"a 0-capacity queue could never admit work")
        self.max_queue = max_queue
        self.obs = obs if obs is not None else Registry(enabled=False)
        self.spans = spans if spans is not None else SpanRecorder()
        self._pending: deque[tuple[Request, Ticket]] = deque()
        self._completions: dict[int, Completion] = {}
        self._order: list[int] = []
        self._metrics: dict[int, RequestMetrics] = {}
        self._next_rid = 0
        self._t0: float | None = None
        self._ext_clock: float | None = None   # last shed clock passed in
        #                                        (the fleet's slot)
        self._shed_buf: list[Completion] = []  # sheds found at admission

    @property
    def queued(self) -> int:
        """Requests waiting for admission."""
        return len(self._pending)

    def pending_requests(self) -> list[Request]:
        """Queued (unadmitted) requests, in queue order."""
        return [req for req, _ in self._pending]

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
        pol = getattr(self, "policy", None)
        if (getattr(pol, "sheds", False) and req.deadline is None
                and pol.slo_s is not None):
            req.deadline = ticket.submitted_at + pol.slo_s
        self._metrics[rid] = RequestMetrics(rid=rid,
                                            submitted_at=ticket.submitted_at,
                                            model=req.model,
                                            deadline=req.deadline)
        self._order.append(rid)
        self._pending.append((req, ticket))
        return ticket

    def _pop_admission(self) -> tuple[Request, Ticket] | None:
        """Pop the next request to admit: FIFO unless the policy has a
        ``select``.  Under a :class:`ShedPolicy` a selected request past
        its deadline is shed instead (buffered for the next sweep); None
        when the queue is empty or shedding emptied it."""
        pol = getattr(self, "policy", None)
        sheds = getattr(pol, "sheds", False)
        select = getattr(pol, "select", None)
        while self._pending:
            if select is None or len(self._pending) <= 1:
                item = self._pending.popleft()
            else:
                i = int(select([req for req, _ in self._pending]))
                if not 0 <= i < len(self._pending):
                    raise ValueError(f"admission policy {pol!r} selected "
                                     f"index {i}, outside the queue "
                                     f"[0, {len(self._pending)})")
                item = self._pending[i]
                del self._pending[i]
            req, _ticket = item
            if sheds and pol.expired(req.deadline, pol.now(self._clock())):
                self._shed_buf.append(self._shed(req))
                continue
            return item
        return None

    # -- deadline shedding ------------------------------------------------
    def _clock(self) -> float:
        """The slot-domain shed clock: the last slot passed in (the fleet
        executor's), else the engine's own slot counter."""
        if self._ext_clock is not None:
            return self._ext_clock
        return float(getattr(self, "_slot", 0))

    def _shed(self, req: Request) -> Completion:
        """File one past-deadline request as a ``status="shed"``
        completion with no output."""
        m = self._metrics[req.rid]
        m.status = "shed"
        m.finished_at = time.perf_counter()
        c = Completion(ticket=Ticket(rid=req.rid,
                                     submitted_at=m.submitted_at),
                       output=None, metrics=m)
        self._completions[req.rid] = c
        return c

    def _take_shed(self) -> list[Completion]:
        out, self._shed_buf = self._shed_buf, []
        return out

    def shed_expired(self, now: float | None = None) -> list[Completion]:
        """Shed every queued request past its deadline under the engine's
        :class:`ShedPolicy` (none without one).  ``now`` sets the slot
        clock (the fleet executor passes its slot before each RUN, so a
        replay sheds the same set).  Returns the shed completions,
        admission-time sheds included."""
        pol = getattr(self, "policy", None)
        if not getattr(pol, "sheds", False):
            return self._take_shed()
        if now is not None:
            self._ext_clock = float(now)
        now_v = pol.now(self._clock())
        out = self._take_shed()
        kept: deque[tuple[Request, Ticket]] = deque()
        for req, ticket in self._pending:
            if pol.expired(req.deadline, now_v):
                out.append(self._shed(req))
            else:
                kept.append((req, ticket))
        self._pending = kept
        return out

    def withdraw_pending(self, max_n: int | None = None
                         ) -> list[tuple[int, Request]]:
        """Remove up to ``max_n`` queued requests, newest first, and
        un-account them; return ``(rid, request)`` pairs in queue order,
        ready to submit elsewhere (the SEND instruction).  In-flight work
        is never withdrawn."""
        n = (len(self._pending) if max_n is None
             else max(0, min(max_n, len(self._pending))))
        taken = [self._pending.pop() for _ in range(n)][::-1]
        out: list[tuple[int, Request]] = []
        for req, _ticket in taken:
            del self._metrics[req.rid]
            self._order.remove(req.rid)
            out.append((req.rid, req))
        return out

    def _start_clock(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def _finish(self, rid: int, output,
                ready: torch.cuda.Event | None = None) -> Completion:
        """Wait for ``output``'s ready event (CUDA; none on the CPU), mark
        it used by the caller's stream, stamp the finish time, judge the
        deadline and file the completion.  The wait is the span
        ``engine.ready_wait`` (recorded on the CPU too, where it waits for
        nothing)."""
        with self.spans.span("engine.ready_wait", rid=rid):
            if ready is not None:
                ready.synchronize()
        if ready is not None:
            output.record_stream(torch.cuda.current_stream(output.device))
        m = self._metrics[rid]
        m.finished_at = time.perf_counter()
        pol = getattr(self, "policy", None)
        if m.deadline is not None and getattr(pol, "sheds", False):
            m.slo_ok = not pol.expired(m.deadline, pol.now(self._clock()))
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
                          wall_s=wall,
                          slots_observed=int(getattr(self, "_slot", 0)
                                             or getattr(self, "_steps", 0)))
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
    a :class:`QueueFull` pushes that request to later steps without
    blocking the ones behind it (a fleet's other members keep accepting);
    refused requests retry first next step.  ``on_step`` (if given) fires
    after every engine step with the step index.  Returns the engine's
    final result once every request has been served.
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
