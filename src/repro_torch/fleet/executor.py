"""Instruction-stream execution: one pool, and a router over many.

:class:`PoolExecutor` is the fleet's execution back end.  It holds no
scheduling opinion: it executes :mod:`repro_torch.fleet.instructions` against
one ``FleetEngine``'s members — the decisions are already in the stream.
The live ``FleetEngine.step`` feeds it one compiled slot at a time (and
the executor records what it ran); :meth:`PoolExecutor.replay` feeds it a
whole pre-compiled or previously-recorded stream, reproducing the live
run's dispatch trace and outputs bitwise (tested) with no central policy
loop — the property that makes a pool drivable from a serialized stream
instead of Python object references.

:class:`MultiPoolRouter` is the first consumer of that property: N
process-local pools standing in for N hosts, each wrapped in its own
executor, presented as one engine (submit / step / drain / result).  The
router owns only cross-pool concerns:

  * placement — submit routes to the pool with the least outstanding
    work for the request's model;
  * migration — :meth:`migrate` / :meth:`drain_pool` move queued
    (unadmitted) requests between pools as a SEND on the source and a
    RECV on the destination, with request identity re-mapped at the
    router boundary (payloads ride the transport's mailbox —
    ``net.transport``: in memory, spool files, or sockets — never the
    serialized stream);
  * dynamic theta re-leasing — when a pool's observed traffic mix
    drifts past ``rebalance_drift`` (total-variation distance from the
    mix its split was planned for), the router re-plans theta via
    ``planner.plan_fleet`` and issues a REBALANCE, which revokes the
    pool's leases, re-splits c/p at the new theta (Eq.10), and relocates
    the members onto the new split (on one card: new green contexts on
    the new SM counts, where the members capture new graphs; in-flight
    envs keep their ready events and finish on the old ones).

Per-request metrics are re-accounted at each boundary exactly as the
fleet does to its members: latency runs from router submit to member
completion, whichever pool finally served it.

Copy of ``repro/fleet/executor.py``.
"""
from __future__ import annotations

import time
from typing import Mapping, Sequence

from repro_torch.fleet.faults import (FaultInjector, InjectedFault,
                                      PoolCrash, RecoveryConfig)
from repro_torch.fleet.instructions import (ExecRecord, Free, Instruction,
                                            Rebalance, Recv, Run, Send,
                                            SetParam)
from repro_torch.fleet.net.transport import LocalTransport
from repro_torch.fleet.planner import normalize_mix, plan_fleet
from repro_torch.obs import DEFAULT_COUNT_BOUNDS, Registry
from repro_torch.serving.api import (Completion, EngineBase, QueueFull,
                                     Request, RequestMetrics, Ticket)


class SeqCounter:
    """A peekable monotonic counter: the next value to be issued is
    :attr:`n`.  The router records each submission's position in the
    instruction stream as the seq watermark at submit time — everything
    :meth:`MultiPoolRouter.replay` needs to re-interleave submissions
    with execution."""

    def __init__(self):
        self.n = 0

    def __next__(self) -> int:
        v = self.n
        self.n += 1
        return v


class PoolExecutor:
    """Replays instruction streams against one fleet's members.

    fleet      the ``FleetEngine`` whose members (and pool) instructions
               act on
    name       this pool's name in a multi-pool topology (SEND/RECV peers
               address each other by it)
    transport  mailbox binding for SEND/RECV (a ``net.transport`` class:
               the router installs its own, LocalTransport by default,
               SocketTransport inside a worker process); None =
               single-pool, migration instructions are an error
    record     keep the executed stream in :attr:`records` (ExecRecord
               per instruction, with observed advances + wall-clock) —
               what serializes, replays, and exports to Chrome tracing
    injector   optional :class:`~repro_torch.fleet.faults.FaultInjector`,
               consulted at every instruction boundary *before* any
               engine state moves (so a retried instruction re-executes
               against an unchanged pool)
    recovery   :class:`~repro_torch.fleet.faults.RecoveryConfig`: retry budget
               and backoff for injected RUN failures, the per-RUN
               timeout, and the degradation thresholds the router reads
    """

    def __init__(self, fleet, *, name: str = "pool0", transport=None,
                 record: bool = True, injector: FaultInjector | None = None,
                 recovery: RecoveryConfig | None = None):
        self.fleet = fleet
        self.name = name
        self.transport = transport
        self.records: list[ExecRecord] = []
        self._record = record
        self.injector = injector
        self.recovery = recovery or RecoveryConfig()
        self.retries = 0     # RUN attempts re-issued after injected faults
        self.timeouts = 0    # RUNs whose wall time exceeded run_timeout_s
        self._seq = SeqCounter()          # router replaces with a shared
        #                                   counter in multi-pool runs
        self.obs = Registry()             # ...and with a shared registry:
        #                                   one telemetry namespace per run
        self._held: dict[str, list] = {}  # member -> flights whose FREE
        #                                   has not executed yet

    # ------------------------------------------------------------------
    def _arm(self, instr: Instruction, slot: int) -> int:
        """Pass one instruction boundary through the fault injector.
        An :class:`InjectedFault` is retried with bounded exponential
        backoff (the fault fires before any engine state moves, so a
        retry is a clean re-execution); retries exhausted escalate to
        :class:`PoolCrash` — the router's recovery problem.  Returns the
        retries spent, stamped on the record."""
        if self.injector is None:
            return 0
        attempt = 0
        while True:
            try:
                self.injector.before(self.name, instr, slot)
                return attempt
            except InjectedFault as e:
                attempt += 1
                self.retries += 1
                if attempt > self.recovery.max_retries:
                    raise PoolCrash(
                        f"pool {self.name!r}: {instr.op} at slot {slot} "
                        f"still failing after {attempt} attempts "
                        f"(max_retries={self.recovery.max_retries}): {e}"
                    ) from e
                if self.recovery.backoff_s:
                    time.sleep(self.recovery.backoff_s
                               * (2 ** (attempt - 1)))

    def execute(self, instr: Instruction, slot: int) -> list[Completion]:
        """Execute one instruction; returns the completions it
        materialized (FREE, fused RUN, and SLO sheds at a RUN)."""
        retries = self._arm(instr, slot)
        t0 = time.perf_counter()
        fleet = self.fleet
        done: list[Completion] = []
        advances = 0
        shed_n = 0
        if isinstance(instr, Run):
            m = fleet._by_name[instr.member]
            # SLO shedding happens at the dispatch boundary, clocked by
            # the fleet slot — the deterministic domain replay re-derives
            shed = getattr(m.engine, "shed_expired", None)
            if shed is not None:
                expired = list(shed(slot))
                shed_n = len(expired)
                done.extend(fleet._adopt(m, c) for c in expired)
            if instr.fused:
                # opaque member: step() fuses dispatch and block
                for _ in range(instr.slots):
                    if not m.engine.has_work:
                        break
                    done.extend(fleet._adopt(m, c)
                                for c in m.engine.step())
                    m.dispatches += 1
                    fleet._dispatches += 1
                    advances += 1
            else:
                flights = self._held.setdefault(instr.member, [])
                for _ in range(instr.slots):
                    if not m.engine.has_work:
                        break
                    flights.extend(m.engine.advance())
                    m.dispatches += 1
                    fleet._dispatches += 1
                    advances += 1
        elif isinstance(instr, Free):
            m = fleet._by_name[instr.member]
            flights = self._held.pop(instr.member, [])
            done.extend(fleet._adopt(m, c)
                        for c in m.engine.retire(flights))
        elif isinstance(instr, Send):
            if self.transport is None:
                raise RuntimeError(f"pool {self.name!r} executed SEND with "
                                   f"no transport attached; migration "
                                   f"needs a MultiPoolRouter")
            pairs = fleet.withdraw_pending(instr.count,
                                           member=instr.member)
            if (self.injector is not None
                    and self.injector.drops_send(self.name, slot)):
                # lost in transit: the transport un-accounts and (live)
                # re-routes the payloads; the record looks like a normal
                # SEND — the drop itself rides the router's recovery log
                advances = self.transport.drop_send(
                    self.name, instr.peer, pairs, seq=self._seq.n,
                    live=True)
            else:
                advances = self.transport.send(self.name, instr.peer,
                                               pairs)
        elif isinstance(instr, Recv):
            if self.transport is None:
                raise RuntimeError(f"pool {self.name!r} executed RECV with "
                                   f"no transport attached")
            advances = self.transport.recv(self.name, instr.peer,
                                           instr.count, fleet.submit)
        elif isinstance(instr, Rebalance):
            self._rebalance(instr.theta)
        elif isinstance(instr, SetParam):
            self._set_param(instr)
        else:
            raise TypeError(f"unknown fleet instruction {instr!r}")
        t1 = time.perf_counter()
        if (isinstance(instr, Run)
                and self.recovery.run_timeout_s is not None
                and t1 - t0 > self.recovery.run_timeout_s):
            # synchronous execution cannot abort a RUN that already
            # finished — a timeout is a strike, and the router degrades
            # the pool at timeout_strikes (drain + stop placing)
            self.timeouts += 1
            self.obs.counter("fleet_run_timeouts_total",
                             "RUNs past run_timeout_s (strikes)",
                             "wall").inc(labels={"pool": self.name})
        self._observe(instr, slot, advances, shed_n, retries, t1 - t0)
        if self._record:
            self.records.append(ExecRecord(
                instr=instr, slot=slot, seq=next(self._seq),
                advances=advances, t0=t0, t1=t1, retries=retries))
        return done

    def _observe(self, instr: Instruction, slot: int, advances: int,
                 shed_n: int, retries: int, dt: float) -> None:
        """Instrument one *completed* instruction.  Runs after every
        state mutation and never before a possible :class:`PoolCrash`
        escape, so slot-domain counters fire exactly once per recorded
        instruction — live and under :meth:`replay` alike — from values
        the stream signature pins (op, core, advances, slot).  Wall-clock
        values (duration, injector retries) land in the ``wall`` domain."""
        obs = self.obs
        if not obs.enabled:
            return
        pool = {"pool": self.name}
        obs.counter("fleet_instructions_total",
                    "instructions executed, by op", "slot").inc(
            labels={"pool": self.name, "op": instr.op})
        obs.gauge("fleet_slot", "latest executed fleet slot",
                  "slot").set(slot, labels=pool)
        if isinstance(instr, Run):
            member = {"pool": self.name, "member": instr.member}
            obs.counter("fleet_advances_total",
                        "flight advances dispatched by RUNs",
                        "slot").inc(advances, labels=member)
            core = "fused" if instr.fused else (instr.core or "mixed")
            obs.counter("fleet_submesh_busy_slots_total",
                        "RUN advances by dominant submesh", "slot").inc(
                advances, labels={"pool": self.name, "core": core})
            obs.histogram("fleet_run_advances",
                          "advances per RUN instruction", "slot",
                          bounds=DEFAULT_COUNT_BOUNDS).observe(
                advances, labels=pool)
            obs.gauge("fleet_in_flight", "member flights in the pipeline",
                      "slot").set(
                self.fleet._by_name[instr.member].engine.in_flight,
                labels=member)
            obs.counter("fleet_shed_total",
                        "completions shed at the dispatch boundary",
                        "slot").inc(shed_n, labels=member)
        elif isinstance(instr, Free):
            obs.gauge("fleet_in_flight", "member flights in the pipeline",
                      "slot").set(
                self.fleet._by_name[instr.member].engine.in_flight,
                labels={"pool": self.name, "member": instr.member})
        elif isinstance(instr, Send):
            obs.counter("fleet_sent_total",
                        "requests withdrawn onto the mailbox by SENDs",
                        "slot").inc(advances, labels={
                            "pool": self.name, "peer": instr.peer})
        elif isinstance(instr, Recv):
            obs.counter("fleet_recv_total",
                        "requests delivered from the mailbox by RECVs",
                        "slot").inc(advances, labels={
                            "pool": self.name, "peer": instr.peer})
        elif isinstance(instr, SetParam):
            obs.counter("fleet_set_params_total",
                        "SET_PARAM instructions, by param", "slot").inc(
                labels={"pool": self.name, "param": instr.param})
        if retries:
            obs.counter("fleet_run_retries_total",
                        "RUN attempts re-issued after injected faults",
                        "wall").inc(retries, labels=pool)
        obs.histogram("fleet_instr_seconds",
                      "wall-clock window per executed instruction",
                      "wall").observe(dt, labels={"pool": self.name,
                                                  "op": instr.op})

    def execute_slot(self, instrs: Sequence[Instruction],
                     slot: int) -> list[Completion]:
        """Execute one slot's instructions in order.  The compiler's
        RUN-before-FREE ordering is what preserves the block-last rule;
        the executor does not re-sort."""
        done: list[Completion] = []
        for instr in instrs:
            done.extend(self.execute(instr, slot))
        return done

    def inject(self, instr: Instruction) -> list[Completion]:
        """Execute one out-of-band instruction (migration, rebalance) at
        the pool's current slot, recording it in the stream."""
        return self.execute(instr, self.fleet._slot)

    # ------------------------------------------------------------------
    def _set_param(self, instr: SetParam) -> None:
        """Apply one SET_PARAM: ``weight`` mutates the member's fleet
        share directly; any other param dispatches to the member
        engine's ``retune()`` hook (e.g. the LM ``group_size``).  The
        mutation is a recorded instruction, so replaying the stream
        re-applies it at the same position — controlled runs stay
        bitwise replayable with nothing else attached."""
        fleet = self.fleet
        m = fleet._by_name.get(instr.member)
        if m is None:
            raise KeyError(f"SET_PARAM for unknown member "
                           f"{instr.member!r} (members: "
                           f"{[x.name for x in fleet.members]})")
        if instr.param == "weight":
            m.weight = float(instr.value)
            return
        retune = getattr(m.engine, "retune", None)
        if retune is None:
            raise RuntimeError(
                f"member {instr.member!r} has no retune() hook; cannot "
                f"SET_PARAM {instr.param!r} (only 'weight' applies to "
                f"every member)")
        retune(**{instr.param: instr.value})

    # ------------------------------------------------------------------
    def _rebalance(self, theta: float) -> None:
        """Revoke every lease, re-split the pool at ``theta``, re-lease,
        and relocate the members onto the new split (each drops its
        lanes and captures new ones in the new partitions)."""
        pool = self.fleet.pool
        if pool is None:
            raise RuntimeError(f"pool {self.name!r} executed REBALANCE "
                               f"but the fleet holds no DevicePool")
        held = pool.revoke_all()
        cores = pool.resplit(theta)
        for m in self.fleet.members:
            if m.name in held:
                pool.lease(m.name)
            if hasattr(m.engine, "relocate"):
                m.engine.relocate(cores)

    # ------------------------------------------------------------------
    def replay(self, records: Sequence[ExecRecord],
               requests: Sequence[Request | object] = (),
               arrivals: Sequence[int] | None = None):
        """Drive the fleet from a compiled or previously-recorded stream:
        the ``serving.api.replay`` arrival loop, with each non-empty slot
        executed from the stream instead of asked of the policy.  Returns
        the fleet's final ``ServeResult``.

        The stream must cover the run: running out of instructions while
        members still hold work means the stream was compiled for a
        different request trace, and raises.
        """
        fleet = self.fleet
        slots: list[tuple[int, list[Instruction]]] = []
        for r in records:
            if slots and slots[-1][0] == r.slot:
                slots[-1][1].append(r.instr)
            else:
                slots.append((r.slot, [r.instr]))
        arrivals = (list(arrivals) if arrivals is not None
                    else [0] * len(requests))
        if len(arrivals) != len(requests):
            raise ValueError(f"{len(requests)} requests but "
                             f"{len(arrivals)} arrival times")
        order = sorted(range(len(requests)), key=lambda i: arrivals[i])
        refused: list[int] = []
        gi, nxt, step = 0, 0, 0
        while nxt < len(order) or refused or fleet.has_work:
            due, refused = refused, []
            while nxt < len(order) and arrivals[order[nxt]] <= step:
                due.append(order[nxt])
                nxt += 1
            for i in due:
                try:
                    fleet.submit(requests[i])
                except QueueFull:
                    refused.append(i)   # retry first next step, as replay()
            if fleet.has_work:
                if gi >= len(slots):
                    raise ValueError(
                        f"instruction stream exhausted after {gi} slots "
                        f"with work still outstanding (queued="
                        f"{fleet.queued}, in_flight={fleet.in_flight}); "
                        f"was it compiled for this request trace?")
                fleet._start_clock()
                slot_no, instrs = slots[gi]
                gi += 1
                self.execute_slot(instrs, slot_no)
                fleet._slot = slot_no + 1
            step += 1
        return fleet.result()


# --------------------------------------------------------------------------
# multi-pool serving
# --------------------------------------------------------------------------
class MultiPoolRouter(EngineBase):
    """One engine surface over N pools (module docstring).

    fleets           {pool name: FleetEngine}; each fleet keeps (and the
                     router adopts) its own :class:`PoolExecutor`
    rebalance_drift  total-variation distance between a pool's observed
                     and planned traffic mix beyond which the router
                     re-plans theta and issues REBALANCE (None = never)
    rebalance_every  slots between drift checks
    plan_evals       search budget handed to ``planner.plan_fleet`` when
                     re-planning theta
    injector         optional :class:`~repro_torch.fleet.faults.FaultInjector`
                     armed on every pool's executor
    recovery         :class:`~repro_torch.fleet.faults.RecoveryConfig` shared
                     by every executor and the router's own degradation
                     / crash-recovery decisions

    Fault tolerance (DESIGN.md §12): a :class:`PoolCrash` raised by a
    pool's step marks the pool dead and re-routes its un-retired
    requests — reconstructed from the source map the placement log
    maintains, re-submitted from the router's journal — onto surviving
    pools (``status="recovered"``); requests no surviving pool can serve
    complete as ``status="failed"``.  Every recovery decision is logged
    as a seq-watermarked event on :attr:`events`, which extends the
    placement log: :meth:`replay` applies the events at the same stream
    positions, so a faulted run replays bitwise — same streams, same
    shed set, same recovered and failed rids — with no injector
    attached.  Retirement is at-most-once: a completion for an
    already-completed rid is dropped (``duplicates_dropped``).
    """

    def __init__(self, fleets: Mapping[str, object], *,
                 rebalance_drift: float | None = None,
                 rebalance_every: int = 16,
                 plan_evals: int = 8,
                 injector: FaultInjector | None = None,
                 recovery: RecoveryConfig | None = None,
                 transport=None):
        super().__init__(max_queue=None)
        if not fleets:
            raise ValueError("a MultiPoolRouter needs at least one pool")
        self.executors: dict[str, PoolExecutor] = {}
        self._seq = SeqCounter()
        self.obs = Registry()
        self.recovery = recovery or RecoveryConfig()
        # the SEND/RECV mailbox (net.transport); accounting stays here,
        # on the on_send/on_drop/on_recv hooks, whatever carries payloads
        self.transport = (transport if transport is not None
                          else LocalTransport())
        self.transport.bind(self)
        self.transport.obs = self.obs
        for name, fleet in fleets.items():
            ex = fleet.executor
            ex.name = name
            ex.transport = self.transport
            ex._seq = self._seq         # router-wide order across pools
            ex.obs = self.obs           # ...and one telemetry namespace
            ex.recovery = self.recovery
            if injector is not None:
                ex.injector = injector
            self.executors[name] = ex
        self.rebalance_drift = rebalance_drift
        self.rebalance_every = rebalance_every
        self.plan_evals = plan_evals
        self.rebalances: list[tuple[str, float]] = []
        self.placements: list[tuple[int, str]] = []
        #    per submission, in order: (stream seq watermark at submit
        #    time, pool placed on) — with the per-pool streams, the full
        #    recipe for re-executing the run (:meth:`replay`)
        self._sources: dict[tuple[str, int], int] = {}
        #                    (pool, fleet rid) -> router rid
        self._served: dict[str, dict[str, int]] = {
            name: {} for name in self.executors}
        self._steps = 0
        # --- fault-tolerance state -------------------------------------
        self.dead: dict[str, str] = {}       # pool -> crash reason
        self.degraded: set[str] = set()      # drained, not placed on
        self.events: list[tuple] = []
        #    chronological recovery log, seq-watermarked like placements:
        #    ("fail", wm, pool) | ("recover", wm, pool, rid) |
        #    ("drop", seq_of_send) — with streams + placements, the full
        #    recipe for replaying a faulted run
        self.duplicates_dropped = 0
        self._journal: dict[int, Request] = {}
        #    rid -> device-free copy of the request, kept until
        #    retirement — what crash recovery re-submits
        self._retry: list[int] = []          # rids awaiting re-placement
        #                                      (every candidate was full)
        self._recovery_done: list[Completion] = []
        #    terminal completions recovery produced outside a step
        self._replay_drops: set[int] = set()

    # ------------------------------------------------------------------
    @property
    def pools(self) -> list[str]:
        """Pool names, in construction order."""
        return list(self.executors)

    @property
    def alive(self) -> list[str]:
        """Pool names not marked dead."""
        return [n for n in self.executors if n not in self.dead]

    @property
    def in_transit(self) -> int:
        """Requests currently riding the SEND/RECV mailbox."""
        return self.transport.in_transit

    @property
    def has_work(self) -> bool:
        # a dead pool's fleet may hold phantom queued/in-flight state —
        # its requests were already re-routed or failed, so it does not
        # count as outstanding work
        """True while any live pool, the mailbox, or retry/recovery backlogs
        hold work."""
        return (any(self.executors[n].fleet.has_work for n in self.alive)
                or self.in_transit > 0 or bool(self._retry)
                or bool(self._recovery_done))

    @property
    def queued(self) -> int:
        """Queued requests across live pools, mailbox, and retry backlog."""
        return (sum(self.executors[n].fleet.queued for n in self.alive)
                + self.in_transit + len(self._retry))

    @property
    def in_flight(self) -> int:
        """Admitted requests across live pools."""
        return sum(self.executors[n].fleet.in_flight for n in self.alive)

    # ------------------------------------------------------------------
    def _outstanding(self, name: str) -> int:
        ex = self.executors[name]
        return ex.fleet.queued + ex.fleet.in_flight

    def _placeable(self, model: str | None = None) -> list[str]:
        """Pools new work may be placed on: not dead, not degraded, and
        (with a model tag) serving the model."""
        return [n for n in self.executors
                if n not in self.dead and n not in self.degraded
                and (model is None
                     or model in self.executors[n].fleet.router.names)]

    def submit(self, request: Request | object) -> Ticket:
        """Route to the pool with the least outstanding work among the
        live pools whose fleet serves the request's model (degraded
        pools only as a last resort)."""
        req = request if isinstance(request, Request) else Request(request)
        cands = self._placeable(req.model)
        if not cands:       # every serving pool degraded: place anyway —
            #                 degraded beats rejected
            cands = [n for n in self.alive
                     if req.model is None
                     or req.model in self.executors[n].fleet.router.names]
        if not cands:
            served = {n: self.executors[n].fleet.router.names
                      for n in self.alive}
            raise KeyError(f"no pool serves model {req.model!r} among "
                           f"live pools (pools serve: {served})")
        name = min(cands, key=self._outstanding)
        try:
            return self._submit_to(name, req)
        except PoolCrash as e:      # a remote pool can die at the submit
            #                         boundary; recover and re-place
            self._recovery_done.extend(self._fail_pool(name, str(e)))
            return self.submit(req)

    def _submit_to(self, pool: str, req: Request) -> Ticket:
        """Submit into a specific pool, with router-level accounting and
        the placement logged (seq watermark, pool) for replay."""
        ex = self.executors[pool]
        submitted_at = time.perf_counter()
        ticket = ex.fleet.submit(
            Request(payload=req.payload, gen_steps=req.gen_steps,
                    model=req.model, deadline=req.deadline,
                    priority=req.priority))
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        self._metrics[rid] = RequestMetrics(rid=rid,
                                            submitted_at=submitted_at,
                                            model=req.model)
        self._order.append(rid)
        self._sources[(pool, ticket.rid)] = rid
        self.placements.append((self._seq.n, pool))
        self.obs.counter("router_placements_total",
                         "requests placed, by pool", "slot").inc(
            labels={"pool": pool})
        self._journal[rid] = Request(payload=req.payload,
                                     gen_steps=req.gen_steps,
                                     model=req.model,
                                     deadline=req.deadline,
                                     priority=req.priority)
        return Ticket(rid=rid, submitted_at=submitted_at)

    def step(self) -> list[Completion]:
        """One slot on every live pool (each pool compiles + executes its
        own slot), recovering from any :class:`PoolCrash` a pool's step
        escalates, then the periodic degradation and drift checks."""
        self._start_clock()
        done: list[Completion] = []
        if self._recovery_done:     # terminal completions a recovery
            done.extend(self._recovery_done)    # produced between steps
            self._recovery_done = []
        self._flush_retry(done)
        for name in list(self.executors):
            if name in self.dead:
                continue
            ex = self.executors[name]
            try:
                pool_done = ex.fleet.step()
            except PoolCrash as e:
                done.extend(self._fail_pool(name, str(e)))
                continue
            done.extend(c2 for c2 in (self._adopt(name, c)
                                      for c in pool_done)
                        if c2 is not None)
        self._steps += 1
        if self.obs.enabled:
            # live loop shape (replay never calls step): wall domain
            self.obs.counter("router_steps_total", "router step calls",
                             "wall").inc()
            self.obs.gauge("router_queue_depth",
                           "queued requests across live pools + mailbox",
                           "wall").set(self.queued)
            self.obs.gauge("router_in_transit",
                           "requests riding the SEND/RECV mailbox",
                           "wall").set(self.in_transit)
        self._check_degradation()
        if (self.rebalance_drift is not None
                and self._steps % self.rebalance_every == 0):
            self._check_drift()
        return done

    def _adopt(self, pool: str, c: Completion) -> Completion | None:
        """Re-account a pool completion at the router boundary (same move
        as ``FleetEngine._adopt`` one layer down).  Returns None for a
        duplicate retirement (a rid already completed — at-most-once is
        the router's invariant, not the pools')."""
        key = (pool, c.ticket.rid)
        if key not in self._sources:
            raise ValueError(
                f"pool {pool!r} retired rid {c.ticket.rid}, but the "
                f"placement log routed no outstanding request there — "
                f"the streams and the placement log disagree (offending "
                f"member rid {c.ticket.rid} on pool {pool!r})")
        rid = self._sources.pop(key)
        if rid in self._completions:
            self.duplicates_dropped += 1
            self.obs.counter("router_duplicates_dropped_total",
                             "duplicate retirements dropped "
                             "(at-most-once)", "wall").inc()
            return None
        m = self._metrics[rid]
        m.started_at = c.metrics.started_at
        m.finished_at = c.metrics.finished_at
        m.slo_ok = c.metrics.slo_ok
        m.deadline = c.metrics.deadline
        if c.metrics.status != "ok":
            # shed/failed always win; a member's plain "ok" never
            # clobbers a "recovered" the router already stamped
            m.status = c.metrics.status
        fc = Completion(ticket=Ticket(rid=rid,
                                      submitted_at=m.submitted_at),
                        output=c.output, metrics=m)
        self._completions[rid] = fc
        self._journal.pop(rid, None)
        model = c.metrics.model or "?"
        served = self._served[pool]
        served[model] = served.get(model, 0) + 1
        self.obs.counter("router_retired_total",
                         "completions retired at the router, by "
                         "pool/model/status", "slot").inc(
            labels={"pool": pool, "model": model, "status": m.status})
        return fc

    # ------------------------------------------------------------------
    # crash recovery (DESIGN.md §12)
    # ------------------------------------------------------------------
    def _log_event(self, ev: tuple) -> None:
        """Append one recovery event and count it.  Every event-log
        write — live (`_fail_pool`, `_reroute`, `on_drop`) and replayed
        (`_apply_event` re-appends at the same watermark) — funnels
        through here, so ``router_recovery_events_total`` is a pure
        function of the event log and replays dict-equal."""
        self.events.append(ev)
        self.obs.counter("router_recovery_events_total",
                         "recovery events logged, by kind", "slot").inc(
            labels={"kind": ev[0]})

    def _pop_sources(self, pool: str) -> list[int]:
        """Withdraw and return the router rids of every request the
        placement log still maps onto ``pool``."""
        keys = [k for k in self._sources if k[0] == pool]
        return [self._sources.pop(k) for k in keys]

    def _fail_request(self, rid: int) -> Completion:
        """Retire ``rid`` as failed: no surviving pool can serve it."""
        self.obs.counter("router_failed_total",
                         "requests no surviving pool could serve",
                         "slot").inc()
        m = self._metrics[rid]
        m.status = "failed"
        m.finished_at = time.perf_counter()
        fc = Completion(ticket=Ticket(rid=rid,
                                      submitted_at=m.submitted_at),
                        output=None, metrics=m)
        self._completions[rid] = fc
        self._journal.pop(rid, None)
        return fc

    def _reroute(self, rid: int, *, wm: int) -> list[Completion]:
        """Re-place one un-retired request on a surviving pool, logging
        the recovery at seq watermark ``wm``.  Returns the terminal
        completions produced (a failure when nothing can serve it; empty
        on a successful or deferred re-placement)."""
        req = self._journal.get(rid)
        if req is None:     # already terminal (shouldn't happen, but a
            return []       # lost journal entry must not crash recovery)
        cands = sorted(self._placeable(req.model), key=self._outstanding)
        if not cands:
            return [self._fail_request(rid)]
        for name in cands:
            try:
                ticket = self.executors[name].fleet.submit(
                    Request(payload=req.payload, gen_steps=req.gen_steps,
                            model=req.model, deadline=req.deadline,
                            priority=req.priority))
            except QueueFull:
                continue
            except PoolCrash as e:  # the candidate died mid-recovery:
                #                     fail it too, keep trying the rest
                self._recovery_done.extend(self._fail_pool(name, str(e)))
                continue
            self._sources[(name, ticket.rid)] = rid
            self._metrics[rid].status = "recovered"
            self._log_event(("recover", wm, name, rid))
            return []
        self._retry.append(rid)     # every candidate full: try again at
        return []                   # the next step boundary

    def _flush_retry(self, done: list[Completion]) -> None:
        """Re-attempt rids whose recovery found every candidate full."""
        if not self._retry:
            return
        backlog, self._retry = self._retry, []
        wm = self._seq.n
        for rid in backlog:
            done.extend(self._reroute(rid, wm=wm))

    def _fail_pool(self, name: str, reason: str) -> list[Completion]:
        """Mark pool ``name`` dead and recover its un-retired requests:
        re-route each onto a surviving pool (``status="recovered"``) or
        retire it as failed.  Logged on :attr:`events` at the current
        seq watermark so replay re-derives the same decisions."""
        self.dead[name] = reason
        wm = self._seq.n
        self._log_event(("fail", wm, name))
        done: list[Completion] = []
        ex = self.executors[name]
        lost: list[int] = []
        for key in [k for k in self._sources if k[0] == name]:
            c = ex.fleet._completions.get(key[1])
            if c is not None:
                # the crash interrupted the step after this request had
                # already retired on the pool — harvest the completion
                # instead of re-running it (replay reaches it through
                # the recorded stream, before the fail event applies)
                fc = self._adopt(name, c)
                if fc is not None:
                    done.append(fc)
            else:
                lost.append(self._sources.pop(key))
        # payloads in transit TO the dead pool (SENT, not yet RECVed)
        # would strand the mailbox forever — recover them too
        lost.extend(self.transport.drain_for(name))
        for rid in sorted(lost):
            done.extend(self._reroute(rid, wm=wm))
        self._degrade_after_crash(name)
        return done

    def _degrade_after_crash(self, dead_pool: str) -> None:
        """Graceful degradation: re-lease the survivor now carrying the
        recovered load (a REBALANCE in its stream marks the adoption).
        The split is kept at the survivor's current theta: theta depends
        on the mix *proportions*, which the merged load preserves — only
        the magnitude doubled — and re-planning mid-crash would stall
        recovery behind a re-plan."""
        if not self.recovery.rebalance_on_crash:
            return
        cands = [n for n in self._placeable()
                 if self.executors[n].fleet.pool is not None]
        if not cands:       # stub fleets (no DevicePool): nothing to
            return          # re-split
        target = min(cands, key=self._outstanding)
        ex = self.executors[target]
        mix = normalize_mix({m.name: m.weight for m in ex.fleet.members})
        try:
            self.rebalance(target, mix=mix, theta=ex.fleet.pool.theta)
        except Exception:   # degraded-but-alive beats a re-lease error
            pass            # escalating a crash we already survived

    def _check_degradation(self) -> None:
        """Degrade pools whose RUN timeouts crossed ``timeout_strikes``:
        drain their queue to a sibling and stop placing new work there
        (in-flight work finishes where it is).  Degradation only affects
        live placement — the drain's SEND/RECV land in the recorded
        streams, so replay needs no event."""
        if self.recovery.run_timeout_s is None:
            return
        for name, ex in self.executors.items():
            if name in self.dead or name in self.degraded:
                continue
            if ex.timeouts < self.recovery.timeout_strikes:
                continue
            if not [n for n in self._placeable() if n != name]:
                continue    # nowhere to shift the load: keep serving
            self.degraded.add(name)
            self.drain_pool(name)

    # ------------------------------------------------------------------
    # migration (SEND on the source, RECV on the destination)
    # ------------------------------------------------------------------
    def migrate(self, src: str, dst: str, *, member: str | None = None,
                count: int | None = None) -> int:
        """Move up to ``count`` queued requests from pool ``src`` to pool
        ``dst`` (None = all queued; ``member`` restricts to one model).
        Returns the number moved."""
        if src == dst:
            raise ValueError(f"cannot migrate pool {src!r} to itself")
        for name in (src, dst):
            if name not in self.executors:
                raise KeyError(f"unknown pool {name!r} "
                               f"(pools: {self.pools})")
        try:
            self.executors[src].inject(Send(peer=dst, member=member,
                                            count=count))
        except PoolCrash as e:      # crash at the SEND boundary: nothing
            #                         left the source — normal recovery
            self._recovery_done.extend(self._fail_pool(src, str(e)))
            return 0
        moved = self.transport.pending(src, dst)
        self.obs.counter("router_migrations_total",
                         "requests moved by migrate()/drain_pool()",
                         "wall").inc(moved, labels={"src": src,
                                                    "dst": dst})
        try:
            self.executors[dst].inject(Recv(peer=src))
        except PoolCrash as e:      # crash at the RECV boundary: the
            #                         payloads are in transit — _fail_pool
            #                         drains the mailbox and re-routes
            self._recovery_done.extend(self._fail_pool(dst, str(e)))
        return moved

    def drain_pool(self, name: str) -> int:
        """Evacuate every queued request of pool ``name`` to the least
        outstanding placeable sibling (in-flight work finishes where it
        is; the pool takes no new admissions once its queue is empty)."""
        others = [n for n in self._placeable() if n != name]
        if not others:
            raise ValueError(f"cannot drain {name!r}: no other live, "
                             f"non-degraded pool to drain into")
        dst = min(others, key=self._outstanding)
        return self.migrate(name, dst)

    # accounting hooks the transport calls at SEND/RECV boundaries ------
    def on_send(self, src: str, dst: str,
                pairs) -> list[tuple[int, Request]] | None:
        """Account one SEND: translate member rids to router rids for
        the transport to carry.  Returns None when replay re-drops a
        recorded loss — the payloads must vanish here too, or the later
        RECV delivers requests the live run never saw."""
        if self._seq.n in self._replay_drops:
            self.on_drop(src, dst, pairs, seq=self._seq.n, live=False)
            return None
        if dst not in self.executors:
            raise KeyError(f"SEND to unknown pool {dst!r} "
                           f"(pools: {self.pools})")
        return [(self._sources.pop((src, frid)), req)
                for frid, req in pairs]

    def on_drop(self, src: str, dst: str, pairs, *, seq: int,
                live: bool) -> int:
        """A SEND lost in transit: un-account the withdrawn requests and
        (live) re-route each onto a placeable pool.  Logged as
        ``("drop", seq)`` so replay drops the same SEND, plus one
        recover event per re-placement at watermark ``seq + 1`` — the
        live resubmission happened *after* the SEND withdrew its
        payloads, so replay must apply it after the SEND record too.
        Returns ``len(pairs)`` either way: the record's ``advances``
        match a delivered SEND bitwise."""
        self._log_event(("drop", seq))
        for frid, _req in pairs:
            rid = self._sources.pop((src, frid))
            if live:
                self._recovery_done.extend(self._reroute(rid, wm=seq + 1))
        return len(pairs)

    def on_recv(self, dst: str, rid: int, frid: int) -> None:
        """Account one delivered payload: router rid ``rid`` now lives on
        pool ``dst`` under member rid ``frid``."""
        self._sources[(dst, frid)] = rid

    # ------------------------------------------------------------------
    # dynamic theta re-leasing
    # ------------------------------------------------------------------
    def observed_mix(self, pool: str) -> dict[str, float]:
        """Per-model share of the traffic pool ``pool`` has completed
        since its last rebalance."""
        served = self._served[pool]
        total = sum(served.values())
        if not total:
            return {}
        return {m: n / total for m, n in served.items()}

    def _check_drift(self) -> None:
        for name, ex in self.executors.items():
            fleet = ex.fleet
            if fleet.pool is None or name in self.dead:
                continue
            observed = self.observed_mix(name)
            if len(observed) < 2:       # one model (or nothing) served:
                continue                # no mix to drift
            planned = normalize_mix(
                {m.name: m.weight for m in fleet.members})
            drift = 0.5 * sum(
                abs(observed.get(k, 0.0) - planned.get(k, 0.0))
                for k in set(observed) | set(planned))
            if drift > self.rebalance_drift:
                try:
                    self.rebalance(name, mix=observed)
                except PoolCrash as e:      # crash at the REBALANCE
                    self._recovery_done.extend(    # boundary
                        self._fail_pool(name, str(e)))

    def rebalance(self, pool: str, *, mix: Mapping[str, float],
                  theta: float | None = None) -> float:
        """Re-plan ``pool`` for traffic ``mix`` and issue REBALANCE.
        ``theta`` overrides the planner (tests pin the split); the pool's
        planned weights are reset to ``mix`` so the drift detector
        measures against the new baseline."""
        ex = self.executors[pool]
        if theta is None:
            theta = plan_fleet(mix, max_evals=self.plan_evals).theta
        ex.inject(Rebalance(theta=theta))
        for m in ex.fleet.members:
            if m.name in mix:
                m.weight = mix[m.name]
                if getattr(ex, "remote", False):
                    # a proxy member's weight is a mirror; the worker's
                    # copy is what schedules: lower the reset through
                    # the stream so replay re-applies it in position
                    ex.inject(SetParam(member=m.name, param="weight",
                                       value=float(mix[m.name])))
        self._served[pool] = {}
        self.rebalances.append((pool, theta))
        return theta

    # ------------------------------------------------------------------
    def stream(self) -> list[ExecRecord]:
        """The executed multi-pool stream, interleaved by the router-wide
        sequence number."""
        out = [r for ex in self.executors.values() for r in ex.records]
        out.sort(key=lambda r: r.seq)
        return out

    def streams(self) -> dict[str, list[ExecRecord]]:
        """Per-pool executed streams (what serializes: one
        ``stream_to_json(records, pool=name)`` document per pool)."""
        return {name: list(ex.records)
                for name, ex in self.executors.items()}

    def replay(self, streams: Mapping[str, Sequence[ExecRecord]],
               placements: Sequence[tuple[int, str]],
               requests: Sequence[Request | object],
               events: Sequence[tuple] = ()):
        """Re-execute a recorded multi-pool run on this (fresh) router:
        every record across every pool executes in router-wide seq order,
        and the i-th request re-submits to its recorded pool exactly when
        it did originally (its placement's seq watermark: before the
        first record with seq >= watermark).  No scheduling or placement
        decision is re-made — the streams plus the placement log ARE the
        run — so the re-executed streams and per-request outputs are
        bitwise-identical to the recording (tested, including runs with
        SEND/RECV migration and mid-run REBALANCE).

        ``events`` extends the recipe to faulted runs: the recorded
        :attr:`events` log replays each crash, recovery and dropped SEND
        at the same stream position (its seq watermark, applied in log
        order) — so a run recorded under fault injection replays bitwise
        with no injector attached, reproducing the same recovered,
        failed and shed sets."""
        unknown = set(streams) - set(self.executors)
        if unknown:
            raise KeyError(f"streams for unknown pools {sorted(unknown)} "
                           f"(pools: {self.pools})")
        if len(placements) != len(requests):
            raise ValueError(f"{len(requests)} requests but "
                             f"{len(placements)} placements")
        events = [tuple(e) for e in events]
        self._replay_drops = {e[1] for e in events if e[0] == "drop"}
        # rids recovered by an event *after* index i: a pool failure
        # only fails the rids no later event recovers
        later_recov: list[set[int]] = [set() for _ in
                                       range(len(events) + 1)]
        for i in range(len(events) - 1, -1, -1):
            later_recov[i] = set(later_recov[i + 1])
            if events[i][0] == "recover":
                later_recov[i].add(events[i][3])
        reqs = [r if isinstance(r, Request) else Request(r)
                for r in requests]
        merged = sorted(((r, pool) for pool, recs in streams.items()
                         for r in recs), key=lambda t: t[0].seq)
        pi = ei = 0
        for r, pool in merged:
            while pi < len(placements) and placements[pi][0] <= r.seq:
                self._submit_to(placements[pi][1], reqs[pi])
                pi += 1
            while ei < len(events) and events[ei][1] <= r.seq:
                self._apply_event(events[ei], later_recov[ei + 1], reqs)
                ei += 1
            ex = self.executors[pool]
            fleet = ex.fleet
            fleet._start_clock()
            self._start_clock()
            for c in ex.execute(r.instr, r.slot):
                self._adopt(pool, c)
            if isinstance(r.instr, (Run, Free)):
                fleet._slot = r.slot + 1
        for _wm, pool in placements[pi:]:   # submissions after the last
            #                                 record (an already-idle run)
            self._submit_to(pool, reqs[pi])
            pi += 1
        while ei < len(events):             # events after the last record
            self._apply_event(events[ei], later_recov[ei + 1], reqs)
            ei += 1
        if self.has_work:
            raise ValueError(
                f"recorded streams exhausted with work still outstanding "
                f"(queued={self.queued}, in_flight={self.in_flight}); "
                f"were they recorded from this request trace?")
        return self.result()

    def _apply_event(self, event: tuple, recovered_later: set[int],
                     reqs: Sequence[Request]) -> None:
        """Apply one recorded recovery event at its replay position.
        Router rids are dense 0..n-1 in submission order, so ``reqs[rid]``
        is the request an event names."""
        kind = event[0]
        if kind == "fail":
            _kind, wm, pool = event
            self.dead[pool] = "replayed crash"
            self._log_event(("fail", wm, pool))
            lost = self._pop_sources(pool)
            # in-transit payloads died with it
            lost.extend(self.transport.drain_for(pool))
            for rid in sorted(lost):
                if rid not in recovered_later:
                    self._fail_request(rid)
        elif kind == "recover":
            _kind, wm, pool, rid = event
            req = reqs[rid]
            ticket = self.executors[pool].fleet.submit(
                Request(payload=req.payload, gen_steps=req.gen_steps,
                        model=req.model, deadline=req.deadline,
                        priority=req.priority))
            self._sources[(pool, ticket.rid)] = rid
            self._metrics[rid].status = "recovered"
            self._log_event(("recover", wm, pool, rid))
        elif kind == "drop":
            pass    # consumed via _replay_drops inside send(); the
            #         replayed drop_send re-logs it at the same position
        else:
            raise ValueError(f"unknown recovery event kind {kind!r} "
                             f"in {event!r}")

    def _extra_stats(self, metrics) -> dict:
        per_pool = {}
        for name, ex in self.executors.items():
            fleet = ex.fleet
            per_pool[name] = {
                "slots": fleet._slot,
                "dispatches": fleet._dispatches,
                "served": dict(self._served[name]),
                "queued": fleet.queued,
                "in_flight": fleet.in_flight,
                "retries": ex.retries,
                "timeouts": ex.timeouts,
            }
            if name in self.dead:
                per_pool[name]["dead"] = self.dead[name]
            if fleet.pool is not None:
                per_pool[name]["pool"] = fleet.pool.stats()
        return {"engine": "multipool",
                "pools": per_pool,
                "steps": self._steps,
                "rebalances": [{"pool": p, "theta": round(t, 4)}
                               for p, t in self.rebalances],
                "in_transit": self.in_transit,
                "dead": sorted(self.dead),
                "degraded": sorted(self.degraded),
                "duplicates_dropped": self.duplicates_dropped,
                "recovery_events": len(self.events),
                "shed": metrics.count("shed"),
                "failed": metrics.count("failed"),
                "recovered": metrics.count("recovered"),
                "aggregate_fps": metrics.requests_per_s(),
                "goodput_fps": metrics.goodput_fps(),
                "per_model": metrics.by_model()}
