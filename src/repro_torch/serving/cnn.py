"""Streaming CNN engine: online admission for the dual-core pipeline.

Port of ``repro/serving/cnn.py``.  Requests queue up (bounded, with
:class:`~repro_torch.serving.api.QueueFull` backpressure), and every
scheduler slot the engine

  1. advances each in-flight stream by one exec group, oldest stream first
     (stream admitted at slot ``s`` runs group ``k - s`` at slot ``k``: the
     paper's one-slot offset, so neighbouring streams occupy different
     cores by the alternation invariant);
  2. admits at most one queued request into the freed group-0 slot (under
     a ``ShedPolicy`` past-deadline requests are shed first);
  3. retires streams that cleared the last group, waiting on each output's
     ready event only after every launch of the slot is queued, so the wait
     never serializes the cross-core overlap.

On a card the launches of one slot go to the two cores' streams and run
concurrently; the host only enqueues.  Capacity equals the number of exec
groups.  The fleet reads :meth:`DualCoreEngine.next_dispatch_cycles` and
:attr:`DualCoreEngine.next_core` to pair a conv-heavy slot of one network
with a dw-heavy slot of another, drives :meth:`DualCoreEngine.advance` and
:meth:`DualCoreEngine.retire` separately, and moves the engine onto a
re-split pool with :meth:`DualCoreEngine.relocate`.
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.dualcore.runtime import READY, DualCoreRunner
from repro_torch.obs import Registry, SpanRecorder
from repro_torch.serving.api import (AdmissionPolicy, Completion,
                                     EngineBase, FixedRateAdmission,
                                     Metrics, RequestMetrics, ServeResult,
                                     Ticket)


@dataclasses.dataclass
class _Flight:
    """One in-flight stream: its env and the next group it will run."""

    rid: int
    env: dict
    next_group: int
    ticket: Ticket
    metrics: RequestMetrics


class DualCoreEngine(EngineBase):
    """Continuous-streaming front end over a :class:`DualCoreRunner`.

    ``record``, when given, receives ``(slot, rid, group, core)`` tuples in
    dispatch order.

    ``obs`` and ``spans`` (disabled when not given) are handed to the
    runner too: the engine's spans (``engine.advance``, ``engine.admit``,
    ``engine.retire``, ``engine.ready_wait``) and the
    runner's go to one recorder, the counters to one registry, read by
    :meth:`snapshot`.
    """

    def __init__(self, runner: DualCoreRunner, *,
                 policy: AdmissionPolicy | None = None,
                 max_queue: int | None = None,
                 record: list | None = None,
                 obs: Registry | None = None,
                 spans: SpanRecorder | None = None):
        super().__init__(max_queue=max_queue, obs=obs, spans=spans)
        runner.obs, runner.spans = self.obs, self.spans
        runner.report_plan()
        self._allocs_seen = self._device_allocs(runner)
        self.runner = runner
        self.policy = policy or FixedRateAdmission(1)
        self.capacity = len(runner.groups)
        self._handles = runner.handles
        self._record = record
        self._flight: list[_Flight] = []      # admission order: oldest first
        self._slot = 0

    @property
    def in_flight(self) -> int:
        """Streams currently in the pipeline."""
        return len(self._flight)

    @property
    def has_work(self) -> bool:
        """True while any queued or in-flight work remains."""
        return bool(self._pending or self._flight)

    def next_dispatch_cycles(self) -> tuple[float, float]:
        """Modelled (c-cycles, p-cycles) the next ``step`` dispatches: each
        in-flight stream's next group on its core, plus group 0 if an
        admission would land (the exec schedule's group latencies)."""
        lat = self.runner.plan.exec_schedule.group_latencies
        groups = self.runner.groups
        cyc = {"c": 0.0, "p": 0.0}
        for f in self._flight:
            cyc[groups[f.next_group].core] += lat[f.next_group]
        if self._pending and len(self._flight) < self.capacity:
            cyc[groups[0].core] += lat[0]
        return cyc["c"], cyc["p"]

    @property
    def next_core(self) -> str | None:
        """Core carrying the larger share of the next step's modelled
        cycles (None when the engine has no work)."""
        if not self.has_work:
            return None
        c, p = self.next_dispatch_cycles()
        return "c" if c >= p else "p"

    def relocate(self, cores) -> None:
        """Move the engine onto a re-split pool (REBALANCE): rebind the
        runner onto ``cores``.  In-flight envs keep their position, their
        ready events, which the next group's stream waits on, and their
        lanes, whose graphs replay on the new streams."""
        self.runner.relocate(cores)

    @staticmethod
    def _device_allocs(runner: DualCoreRunner) -> int | None:
        """The caching allocator's device allocations so far
        (``torch.cuda.memory_stats()["num_device_alloc"]``: its
        ``cudaMalloc`` calls on the runner's card); None on the CPU."""
        if runner.device.type != "cuda":
            return None
        return torch.cuda.memory_stats(runner.device).get("num_device_alloc",
                                                          0)

    def snapshot(self) -> dict:
        """The engine's registry (:meth:`Registry.snapshot`), with
        ``device_allocs_total`` read now on a card (the allocator's
        ``num_device_alloc`` since the engine was made).  Read it at the
        edges of a window, not every slot."""
        n = self._device_allocs(self.runner)
        if n is not None:
            self.obs.counter("device_allocs_total",
                             "the caching allocator's device allocations "
                             "(cudaMalloc calls)", "wall").inc(
                n - self._allocs_seen)
            self._allocs_seen = n
        return self.obs.snapshot()

    def _dispatch(self, f: _Flight) -> None:
        """Run flight ``f``'s next group via the runner's group handle."""
        gi = f.next_group
        h = self._handles[gi]
        f.env = h(f.env, f.rid)
        if self._record is not None:
            self._record.append((self._slot, f.rid, gi, h.core))
        f.next_group = gi + 1

    def step(self) -> list[Completion]:
        """Advance the pipeline by one slot (see module docstring)."""
        return self.retire(self.advance())

    def advance(self) -> list[_Flight]:
        """Dispatch phase of one slot: advance every in-flight stream and
        admit into the freed group-0 slot; return the flights that cleared
        the last group without waiting for them."""
        with self.spans.span("engine.advance", slot=self._slot):
            return self._advance()

    def _advance(self) -> list[_Flight]:
        self._start_clock()
        # shed past-deadline queue entries against the engine's own slot,
        # unless the fleet executor already swept with its slot
        if self._ext_clock is None:
            self._shed_buf.extend(self.shed_expired())
        finished: list[_Flight] = []
        kept: list[_Flight] = []
        for f in self._flight:
            self._dispatch(f)
            (finished if f.next_group >= self.capacity else kept).append(f)
        self._flight = kept
        n = self.policy.admit(queued=len(self._pending),
                              in_flight=len(self._flight),
                              capacity=self.capacity)
        n = max(0, min(n, 1, self.capacity - len(self._flight),
                       len(self._pending)))
        popped = self._pop_admission() if n else None
        if popped is not None:          # None: the rest of the queue shed
            req, ticket = popped
            with self.spans.span("engine.admit", rid=req.rid):
                self._metrics[req.rid].started_at = time.perf_counter()
                f = _Flight(rid=req.rid,
                            env=self.runner.place_input(req.payload),
                            next_group=0, ticket=ticket,
                            metrics=self._metrics[req.rid])
            self._dispatch(f)
            if f.next_group >= self.capacity:   # single-group chain
                finished.append(f)
            else:
                self._flight.append(f)
        self._slot += 1
        return finished

    def retire(self, finished: list[_Flight]) -> list[Completion]:
        """Wait for the outputs of flights returned by :meth:`advance` and
        file their completions, after the sheds of the dispatch phase.
        With compiled groups a finished flight's lane is already back in
        the runner's pool: its last group cloned ``"out"`` out of it, and
        the lane's next user waits on that group's ready event on the card,
        so nothing here waits for it."""
        with self.spans.span("engine.retire", slot=self._slot - 1):
            out = self._take_shed()
            out.extend(self._finish(f.rid, f.env["out"], f.env.get(READY))
                       for f in finished)
            return out

    def _extra_stats(self, metrics: Metrics) -> dict:
        return {"engine": "dualcore", "slots": self._slot,
                "capacity": self.capacity,
                "completed": metrics.completed,
                "queued": len(self._pending),
                "in_flight": len(self._flight),
                "fps": metrics.requests_per_s()}


def stream_images(runner: DualCoreRunner, images, *,
                  policy: AdmissionPolicy | None = None,
                  max_queue: int | None = None,
                  record: list | None = None) -> ServeResult:
    """Serve a ready list of images through a fresh engine (everything
    arrives at slot 0; admission staggers entry one slot apart)."""
    eng = DualCoreEngine(runner, policy=policy, max_queue=max_queue,
                         record=record)
    for x in images:
        eng.submit(x)
    return eng.drain()
