"""The serving loop: the traffic's loop sends requests, the program
serves them slot by slot, and the harness stamps each request.

A run has four phases: ``warm`` (the cell's own traffic until the
program's lanes stop growing; set-up), ``window`` (measured), ``trace``
(a profiled slice after the window, ``--trace 1`` only) and ``drain``
(no new requests until every one is served)."""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time

import torch

#: requests whose outputs the check keeps, drawn from the seed
SAMPLE = 64
#: seconds the traced slice lasts
TRACE_S = 2.0
#: seconds the drain may take
DRAIN_S = 120.0


@dataclasses.dataclass
class Req:
    """One request: its pool batch and its stamps (``perf_counter``)."""

    rid: int
    batch: int
    images: int                  # index into the pool
    due: float
    sent: float
    started: float | None = None    # the program's admission stamp
    done: float | None = None       # its output was ready


@dataclasses.dataclass
class Phase:
    """What one phase did: its slots, the host seconds of the program's
    ``advance``, the launches it counted and the requests served in its
    slots."""

    name: str
    t0: float = 0.0
    t1: float = 0.0
    slots: int = 0
    advance_s: float = 0.0
    launches: int = 0
    lanes: tuple[int, int] = (0, 0)
    served: list[Req] = dataclasses.field(default_factory=list)
    slot_s: list[float] = dataclasses.field(default_factory=list)

    def done_by(self, t: float) -> list[Req]:
        """Requests of this phase served by ``t``."""
        return [r for r in self.served if r.done <= t]


class Feeder:
    """Runs ``program`` under ``loop`` with batches from ``pool``."""

    def __init__(self, program, loop, pool: torch.Tensor, seed: int):
        self.program = program
        self.loop = loop
        self.pool = pool
        self.flight: dict[int, Req] = {}
        self.sent = 0
        self.rng = random.Random(int(seed))
        self.kept: list[tuple[int, torch.Tensor]] = []   # (pool index, out)
        self.offered = 0

    # ------------------------------------------------------------------
    def _slot(self, ph: Phase, send: bool, sample: bool, tracer) -> None:
        span = tracer.span if tracer is not None else (
            lambda name: contextlib.nullcontext())
        t = time.perf_counter()
        if send:
            with span("bench.submit"):
                for due in self.loop.due(t):
                    i = self.sent % len(self.pool)
                    self.sent += 1
                    sent = time.perf_counter()
                    rid = self.program.submit(self.pool[i])
                    self.flight[rid] = Req(rid, self.pool.shape[1], i, due,
                                           sent)
        t1 = time.perf_counter()
        with span("bench.advance"):
            token = self.program.advance()
        t2 = time.perf_counter()
        with span("bench.retire"):
            done = self.program.retire(token)
        t3 = time.perf_counter()
        ph.advance_s += t2 - t1
        ph.slots += 1
        ph.slot_s.append(t3 - t)
        for rid, out, started in done:
            r = self.flight.pop(rid)
            r.started, r.done = started, t3
            ph.served.append(r)
            if sample:
                self._offer(r.images, out)
        if send:
            self.loop.served(len(done))

    def _offer(self, images: int, out: torch.Tensor) -> None:
        """Reservoir sampling: every output served in the window is kept
        with the same chance."""
        if len(self.kept) < SAMPLE:
            self.kept.append((images, out))
        else:
            j = self.rng.randrange(self.offered + 1)
            if j < SAMPLE:
                self.kept[j] = (images, out)
        self.offered += 1

    def _run(self, ph: Phase, until, send: bool = True,
             sample: bool = False, tracer=None) -> Phase:
        ph.t0 = time.perf_counter()
        ph.lanes = (self.program.lanes(), ph.lanes[1])
        n0 = self.program.launches()
        while not until(ph):
            self._slot(ph, send, sample, tracer)
        ph.launches = self.program.launches() - n0
        ph.lanes = (ph.lanes[0], self.program.lanes())
        ph.t1 = time.perf_counter()
        return ph

    # ------------------------------------------------------------------
    def warm(self) -> Phase:
        """The cell's own traffic until the lane pool has not grown for
        two pipelines' worth of slots (at least three pipelines' worth in
        all), so no capture lands in the window."""
        cap = self.program.capacity
        seen = {"lanes": -1, "since": 0}

        def until(ph: Phase) -> bool:
            n = self.program.lanes()
            if n != seen["lanes"]:
                seen["lanes"], seen["since"] = n, ph.slots
            return ph.slots >= max(3 * cap, seen["since"] + 2 * cap) \
                or ph.slots >= 40 * cap

        return self._run(Phase("warm"), until)

    def window(self, seconds: float) -> Phase:
        """The measured window: ``seconds`` of the loop; every output
        served in it may be sampled for the check."""
        end = time.perf_counter() + seconds
        ph = self._run(Phase("window"), lambda ph: time.perf_counter() >= end,
                       sample=True)
        ph.t1 = min(ph.t1, end)
        return ph

    def trace(self, tracer) -> Phase:
        """The traced slice, under ``tracer``."""
        with tracer:
            end = time.perf_counter() + TRACE_S
            ph = self._run(Phase("trace"),
                           lambda ph: time.perf_counter() >= end,
                           tracer=tracer)
        return ph

    def drain(self) -> Phase:
        """Serve what is in flight, sending nothing new."""
        end = time.perf_counter() + DRAIN_S
        return self._run(Phase("drain"),
                         lambda ph: not self.program.has_work
                         or time.perf_counter() >= end, send=False)
