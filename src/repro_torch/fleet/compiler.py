"""Lower fleet scheduling decisions into instruction streams.

Two entry points, one decision kernel:

* :class:`SlotCompiler.lower_slot` is the single place cross-engine
  scheduling decisions become instructions.  Given the per-member
  :class:`~repro_torch.fleet.router.MemberView`\\ s of one scheduler
  slot it asks the :class:`~repro_torch.fleet.router.SchedulingPolicy`
  for the primary member, orders the co-dispatched rest
  core-complementary-first (the cross-network Fig.4b move), applies the
  ``co_dispatch`` width and ``burst`` depth, and emits ``RUN*(pure)
  RUN*(fused) FREE*`` — dispatches strictly before any materialization,
  the block-last rule as an instruction ordering invariant instead of a
  loop convention.  The live ``FleetEngine.step`` is a shim over exactly
  this (compile one slot, execute it).

* :func:`compile_fleet` lowers a whole run ahead of time: it simulates the
  ``replay`` driving loop against :class:`MemberModel` mirrors of the
  member engines — queue depth, pipeline occupancy, per-group cores and
  latencies, the admission policy — without touching a device, and returns
  the full :class:`~repro_torch.fleet.instructions.ExecRecord` stream the live
  fleet would execute for that arrival trace.  Replaying it through
  ``fleet.executor.PoolExecutor.replay`` reproduces the live dispatch
  trace and outputs bitwise (tested); this is what makes per-pool state
  serializable — a router can ship the stream to a pool instead of
  holding a Python loop over its engines.

Members whose slot dynamics the mirror cannot model (an opaque engine with
no ``advance``/``retire`` split and no declared service model, e.g. the LM
``DualMeshEngine``) are rejected by :func:`compile_fleet` with a pointer
at the recorded-stream path: the live shim records the same instruction
stream it executes, which replays identically.

Copy of ``repro/fleet/compiler.py`` (the port imports nothing of
``repro``).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Sequence

from repro_torch.fleet.instructions import (ExecRecord, Free, Instruction,
                                            Run)
from repro_torch.fleet.router import MemberView, SchedulingPolicy
from repro_torch.serving.api import Request


def observe(index: int, name: str, engine, *, weight: float,
            dispatches: int, want_deadlines: bool,
            want_cores: bool) -> MemberView | None:
    """Build the policy-facing view of one member (or None when it has no
    work).  Shared by the live ``FleetEngine._views`` and the compiler's
    mirror loop so compiled and live decisions see identical inputs.
    ``head_deadline`` costs an O(queue) scan and ``next_core`` a walk over
    the in-flight groups — pay them only when something reads them."""
    if not engine.has_work:
        return None
    head = None
    if want_deadlines and hasattr(engine, "pending_requests"):
        deadlines = [r.deadline for r in engine.pending_requests()
                     if r.deadline is not None]
        head = min(deadlines) if deadlines else None
    return MemberView(
        index=index, name=name, queued=engine.queued,
        in_flight=engine.in_flight, weight=weight, dispatches=dispatches,
        head_deadline=head,
        next_core=(getattr(engine, "next_core", None)
                   if want_cores else None),
        has_work=True,
        batched=hasattr(engine, "advance"))


class SlotCompiler:
    """Lowers one scheduler slot's decisions into instructions."""

    def __init__(self, policy: SchedulingPolicy, *,
                 co_dispatch: int | None = None, burst: int = 1):
        self.policy = policy
        self.co_dispatch = co_dispatch
        self.burst = burst

    @property
    def uses_deadlines(self) -> bool:
        """True when the scheduling policy orders by request deadlines."""
        return getattr(self.policy, "uses_deadlines", False)

    @property
    def wants_cores(self) -> bool:
        """True when co-dispatch needs each member's dominant core."""
        return self.co_dispatch is None or self.co_dispatch > 0

    def lower_slot(self, views: Sequence[MemberView],
                   total_dispatches: int) -> list[Instruction]:
        """One slot: policy primary first, then up to ``co_dispatch``
        members core-complementary-first, each RUN up to ``burst`` slots
        deep; every RUN precedes every FREE."""
        i = self.policy.pick(views, total_dispatches)
        by_index = {v.index: v for v in views}
        if i not in by_index:
            raise ValueError(f"policy {self.policy!r} picked member {i}, "
                             f"not among workable {sorted(by_index)}")
        primary = by_index[i]
        batch = [primary]
        rest = [v for v in views if v.index != primary.index]
        if rest and self.wants_cores:
            want = "p" if primary.next_core == "c" else "c"
            # complementary dominant core first, then member order
            rest.sort(key=lambda v: (v.next_core != want, v.index))
            limit = (len(rest) if self.co_dispatch is None
                     else self.co_dispatch)
            batch.extend(rest[:limit])
        runs = [Run(member=v.name, slots=self.burst, core=v.next_core,
                    primary=v.index == primary.index)
                for v in batch if v.batched]
        # opaque members fuse dispatch and block — run them after every
        # pure dispatch is in flight, before any deferrable FREE
        fused = [Run(member=v.name, slots=self.burst, core=v.next_core,
                     primary=v.index == primary.index, fused=True)
                 for v in batch if not v.batched]
        frees = [Free(member=v.name) for v in batch if v.batched]
        return runs + fused + frees


# --------------------------------------------------------------------------
# ahead-of-time compilation against member mirrors
# --------------------------------------------------------------------------
class CompileError(ValueError):
    """The fleet configuration cannot be lowered ahead of time."""


@dataclasses.dataclass
class _Flight:
    remaining_or_group: int          # pipeline: next group; service: left


class MemberModel:
    """Device-free mirror of one member engine's slot dynamics.

    Two shapes, both exact:

    * ``pipeline`` (a ``DualCoreEngine``): capacity = number of exec
      groups, streams advance one group per slot, at most one admission
      per slot into group 0, ``next_core`` priced from the exec
      schedule's per-group latencies — the same arithmetic as
      ``DualCoreEngine.next_dispatch_cycles``.
    * ``service`` (any engine declaring ``capacity`` + ``service_steps`` +
      a fixed ``next_core``, e.g. the test stubs): requests occupy a slot
      for ``service_steps`` advances, admissions per the policy's count.
    """

    def __init__(self, name: str, *, capacity: int, max_queue: int | None,
                 policy, kind: str, service_steps: int = 1,
                 group_cores: Sequence[str] = (),
                 group_latencies: Sequence[float] = (),
                 fixed_core: str | None = None):
        self.name = name
        self.capacity = capacity
        self.max_queue = max_queue
        self.policy = policy
        self.kind = kind
        self.service_steps = service_steps
        self.group_cores = list(group_cores)
        self.group_latencies = list(group_latencies)
        self.fixed_core = fixed_core
        self._pending: list[Request] = []
        self._flight: list[int] = []         # pipeline: next group index;
        #                                      service: remaining advances
        self.completed = 0
        self.shed = 0

    # -- construction ---------------------------------------------------
    @classmethod
    def of_engine(cls, name: str, engine) -> "MemberModel":
        """Build the device-free mirror of one live member engine."""
        runner = getattr(engine, "runner", None)
        if runner is not None and hasattr(runner, "plan"):
            sched = runner.plan.exec_schedule
            return cls(name, capacity=len(runner.groups),
                       max_queue=engine.max_queue, policy=engine.policy,
                       kind="pipeline",
                       group_cores=[g.core for g in runner.groups],
                       group_latencies=list(sched.group_latencies))
        if hasattr(engine, "service_steps") and hasattr(engine, "capacity"):
            return cls(name, capacity=engine.capacity,
                       max_queue=engine.max_queue,
                       policy=getattr(engine, "policy", None),
                       kind="service",
                       service_steps=engine.service_steps,
                       fixed_core=getattr(engine, "next_core", None)
                       or getattr(engine, "_core", None))
        raise CompileError(
            f"member {name!r} ({type(engine).__name__}) is opaque — no "
            f"advance/retire split and no declared service model — so its "
            f"slot dynamics cannot be mirrored ahead of time; drive the "
            f"live FleetEngine (its step() records the same instruction "
            f"stream it executes) and replay that")

    # -- the engine-shaped surface `observe` reads ----------------------
    @property
    def has_work(self) -> bool:
        """True while the mirror holds queued or in-flight work."""
        return bool(self._pending or self._flight)

    @property
    def queued(self) -> int:
        """Requests waiting for admission."""
        return len(self._pending)

    @property
    def in_flight(self) -> int:
        """Streams currently in the mirrored pipeline."""
        return len(self._flight)

    def pending_requests(self) -> list[Request]:
        """Snapshot of the queued (unadmitted) requests."""
        return list(self._pending)

    @property
    def next_core(self) -> str | None:
        """Dominant core of the next dispatch (None when idle)."""
        if not self.has_work:
            return None
        if self.kind == "service":
            return self.fixed_core
        cyc = {"c": 0.0, "p": 0.0}
        for g in self._flight:
            cyc[self.group_cores[g]] += self.group_latencies[g]
        if self._pending and len(self._flight) < self.capacity:
            cyc[self.group_cores[0]] += self.group_latencies[0]
        return "c" if cyc["c"] >= cyc["p"] else "p"

    # -- dynamics -------------------------------------------------------
    def submit(self, req: Request) -> bool:
        """Mirror of ``EngineBase.submit``: False = QueueFull refusal."""
        if self.max_queue is not None \
                and len(self._pending) >= self.max_queue:
            return False
        self._pending.append(req)
        return True

    def _pop_admission(self) -> Request:
        select = getattr(self.policy, "select", None)
        if select is None or len(self._pending) <= 1:
            return self._pending.pop(0)
        return self._pending.pop(int(select(list(self._pending))))

    def shed_expired(self, now: float | int) -> int:
        """Mirror of ``EngineBase.shed_expired`` under the executor's
        slot clock: drop past-deadline queue entries before the slot's
        admission, so the compiled stream prices the same queue the live
        run admits from.  Returns the number shed."""
        pol = self.policy
        if not getattr(pol, "sheds", False):
            return 0
        kept = [r for r in self._pending
                if r.deadline is None
                or not pol.expired(r.deadline, pol.now(float(now)))]
        n = len(self._pending) - len(kept)
        self._pending = kept
        self.shed += n
        return n

    def advance(self) -> int:
        """One scheduler slot; returns the number of streams finishing."""
        finished = 0
        if self.kind == "pipeline":
            kept = []
            for g in self._flight:
                if g + 1 >= self.capacity:
                    finished += 1
                else:
                    kept.append(g + 1)
            self._flight = kept
            n = self.policy.admit(queued=len(self._pending),
                                  in_flight=len(self._flight),
                                  capacity=self.capacity)
            n = max(0, min(n, 1, self.capacity - len(self._flight),
                           len(self._pending)))
            if n:
                self._pop_admission()
                if self.capacity <= 1:          # single-group chain
                    finished += 1
                else:
                    self._flight.append(1)
        else:
            for i in range(len(self._flight)):
                self._flight[i] -= 1
            finished = sum(1 for r in self._flight if r <= 0)
            self._flight = [r for r in self._flight if r > 0]
            n = (self.policy.admit(queued=len(self._pending),
                                   in_flight=len(self._flight),
                                   capacity=self.capacity)
                 if self.policy is not None else len(self._pending))
            for _ in range(max(0, min(n, len(self._pending),
                                      self.capacity - len(self._flight)))):
                self._pop_admission()
                self._flight.append(self.service_steps)
        self.completed += finished
        return finished


def compile_fleet(fleet, requests: Sequence[Request],
                  arrivals: Sequence[int] | None = None
                  ) -> list[ExecRecord]:
    """Lower a ``FleetEngine`` configuration + its policy's decisions into
    the instruction stream ``replay(fleet, requests, arrivals)`` would
    execute — ahead of time, against member mirrors, touching no device.

    The policy object is deep-copied (stateful policies like RoundRobin
    must not have their live state consumed by compilation).  Requests
    only contribute their routing/ordering metadata (model tag, deadline,
    priority); payloads never enter the stream.
    """
    if getattr(fleet, "controller", None) is not None:
        raise CompileError(
            "cannot compile a fleet with a ControlLoop attached: the "
            "controller's decisions depend on observed latencies and "
            "arrival timing, which no device-free mirror can predict "
            "ahead of time; drive the live FleetEngine (its step() "
            "records every injected SET_PARAM/REBALANCE) and replay the "
            "recorded stream")
    models: dict[str, MemberModel] = {
        m.name: MemberModel.of_engine(m.name, m.engine)
        for m in fleet.members}
    weights = {m.name: m.weight for m in fleet.members}
    compiler = SlotCompiler(copy.deepcopy(fleet.policy),
                            co_dispatch=fleet.co_dispatch,
                            burst=fleet.burst)
    arrivals = (list(arrivals) if arrivals is not None
                else [0] * len(requests))
    if len(arrivals) != len(requests):
        raise ValueError(f"{len(requests)} requests but "
                         f"{len(arrivals)} arrival times")
    order = sorted(range(len(requests)), key=lambda i: arrivals[i])
    dispatches = dict.fromkeys(models, 0)
    total_dispatches = 0
    stream: list[ExecRecord] = []
    slot = 0                     # fleet slot counter (skips empty views)
    seq = 0
    refused: list[int] = []
    nxt, step = 0, 0
    names = list(models)
    while nxt < len(order) or refused \
            or any(m.has_work for m in models.values()):
        due, refused = refused, []
        while nxt < len(order) and arrivals[order[nxt]] <= step:
            due.append(order[nxt])
            nxt += 1
        for i in due:
            req = (requests[i] if isinstance(requests[i], Request)
                   else Request(requests[i]))
            name = fleet.router.route(req)
            if not models[name].submit(req):
                refused.append(i)
            # refused requests retry first next step, like replay()
        views = [v for v in (
            observe(i, n, models[n], weight=weights[n],
                    dispatches=dispatches[n],
                    want_deadlines=compiler.uses_deadlines,
                    want_cores=compiler.wants_cores)
            for i, n in enumerate(names)) if v is not None]
        if views:
            for instr in compiler.lower_slot(views, total_dispatches):
                adv = 0
                if isinstance(instr, Run):
                    model = models[instr.member]
                    model.shed_expired(slot)    # same dispatch-boundary
                    #       sweep the executor runs (slot clock), so the
                    #       mirror admits from the same queue
                    for _ in range(instr.slots):
                        if not model.has_work:
                            break
                        model.advance()
                        adv += 1
                    dispatches[instr.member] += adv
                    total_dispatches += adv
                stream.append(ExecRecord(instr=instr, slot=slot, seq=seq,
                                         advances=adv))
                seq += 1
            slot += 1
        step += 1
    return stream


def stream_signature(records: Sequence[ExecRecord]
                     ) -> list[tuple[int, int, Instruction, int]]:
    """The replay-comparable core of a stream: (seq, slot, instruction,
    advances) — wall-clock stamps excluded (they never reproduce)."""
    return [(r.seq, r.slot, r.instr, r.advances) for r in records]


def validate_stream(records: Sequence[ExecRecord]) -> None:
    """Structural invariants every well-formed stream satisfies: slots
    monotone, seq strictly increasing, and within a slot every RUN
    precedes every FREE (the block-last rule)."""
    last_slot, last_seq = -1, -1
    freed_in_slot = False
    for r in records:
        if r.slot < last_slot:
            raise ValueError(f"slot went backwards at seq {r.seq}: "
                             f"{last_slot} -> {r.slot}")
        if r.seq <= last_seq:
            raise ValueError(f"seq not strictly increasing at {r.seq}")
        if r.slot != last_slot:
            freed_in_slot = False
        if isinstance(r.instr, Free):
            freed_in_slot = True
        elif isinstance(r.instr, Run) and freed_in_slot:
            raise ValueError(f"RUN after FREE within slot {r.slot} "
                             f"(seq {r.seq}): dispatch must precede "
                             f"materialization")
        last_slot, last_seq = r.slot, r.seq
