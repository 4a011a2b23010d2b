"""FleetEngine: several networks through one serving front end.

Port of ``repro/fleet/engine.py``.  :class:`FleetEngine` implements the
serving protocol (submit / step / drain / result), so ``replay`` and the
arrival traces drive a fleet unchanged.  Members are engines
(``DualCoreEngine`` per CNN); the fleet owns the *cross-engine* decisions
and nothing else:

  1. ``submit`` routes on ``Request.model`` (``fleet.router.Router``) and
     forwards into the member's own bounded queue, so backpressure stays
     per member.

  2. ``step`` picks the PRIMARY member via the pluggable
     :class:`~repro_torch.fleet.router.SchedulingPolicy` (round-robin /
     shortest-queue / weighted-fair / deadline-EDF): its exec groups are
     dispatched first.

  3. The fleet then co-dispatches up to ``co_dispatch`` further members
     into the same slot, ordered by the scheduler's per-group latency
     model (``DualCoreEngine.next_dispatch_cycles``): the member whose
     dominant core is the *opposite* of the primary's goes next, so a
     conv-heavy group of network A and a dw-heavy group of network B land
     on the c and p streams of the shared pool back to back (the
     multi-network Fig.4b offset, the mechanism behind the Table VII
     multi-CNN claim).  ``co_dispatch=None`` admits every member with
     work; ``co_dispatch=0`` steps only the policy's pick.

  4. Dispatch strictly precedes waiting: every batched member
     ``advance``s (its launches queued on the streams) before any member
     ``retire``s (a host wait on a finished output's ready event).
     Waiting on member A's output before member B's groups are queued
     would serialize on the host exactly the cross-network overlap this
     layer exists for.

  5. ``burst`` advances each batched member that many consecutive slots
     per fleet step (retiring once, at the end): fewer switches between
     networks, at the cost of up to ``burst-1`` slots of queueing for the
     others.

Per-request metrics are accounted at the fleet boundary: latency runs
from fleet submit to member completion, tagged with the model, so
``result().metrics.by_model()`` gives the per-network p50/p95.  A
closed-loop controller (:class:`~repro_torch.fleet.control.ControlLoop`)
attaches itself as :attr:`FleetEngine.controller` and is consulted after
every executed slot; its actions are instructions injected into the
recorded stream, so a controlled run replays with no controller attached.
Members need not be CNNs: an LM ``DualMeshEngine`` (no advance/retire
split) runs as fused RUNs.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Mapping, Sequence

import torch

from repro_torch.core.arch import DUAL_BASELINE, BoardModel
from repro_torch.core.scheduler import best_schedule, build_schedule
from repro_torch.dualcore.runtime import DualCoreRunner
from repro_torch.fleet.compiler import SlotCompiler, observe
from repro_torch.fleet.executor import PoolExecutor
from repro_torch.fleet.pool import DevicePool
from repro_torch.fleet.router import (MemberView, RoundRobin, Router,
                                      SchedulingPolicy)
from repro_torch.models.cnn import build_model
from repro_torch.serving.api import (AdmissionPolicy, Completion,
                                     EngineBase, Metrics, QueueFull, Request,
                                     RequestMetrics, Ticket)
from repro_torch.serving.cnn import DualCoreEngine


@dataclasses.dataclass
class Member:
    """One network's engine inside the fleet."""

    name: str
    engine: object                   # anything satisfying serving.Engine
    weight: float = 1.0              # traffic-mix share (unnormalized ok)
    dispatches: int = 0              # fleet steps received
    rid_map: dict[int, int] = dataclasses.field(default_factory=dict)
    #                                  member rid -> fleet rid


class FleetEngine(EngineBase):
    """Multiplex member engines over one device pool (module docstring).

    members      {model name: engine}; insertion order is the round-robin
                 / tie-break order
    policy       cross-engine :class:`SchedulingPolicy` (default
                 RoundRobin)
    weights      {model name: qps share} for weighted-fair scheduling and
                 the stats breakdown (default: equal)
    admission    per-model :class:`AdmissionPolicy` map installed onto the
                 member engines (e.g. ``{"mobilenet_v1":
                 DeadlineAdmission()}``); members keep their own policy
                 when absent from the map
    co_dispatch  max members co-dispatched into a slot beyond the primary
                 (None = every member with work, the throughput default;
                 0 = policy-only stepping, the latency-sensitive mode)
    burst        consecutive slots each batched member advances per fleet
                 step (locality amortization, module docstring point 5)
    pool         the shared :class:`DevicePool`, for stats only — runners
                 must already hold their leases
    """

    def __init__(self, members: Mapping[str, object], *,
                 policy: SchedulingPolicy | None = None,
                 weights: Mapping[str, float] | None = None,
                 admission: Mapping[str, AdmissionPolicy] | None = None,
                 co_dispatch: int | None = None,
                 burst: int = 1,
                 pool: DevicePool | None = None):
        super().__init__(max_queue=None)   # members bound their own queues
        self.router = Router(list(members))
        self.members = [Member(name=n, engine=e,
                               weight=(weights or {}).get(n, 1.0))
                        for n, e in members.items()]
        self._by_name = {m.name: m for m in self.members}
        for name, pol in (admission or {}).items():
            if name not in self._by_name:
                raise KeyError(f"admission policy for unknown member "
                               f"{name!r} (members: {list(members)})")
            self._by_name[name].engine.policy = pol
        self.policy = policy or RoundRobin()
        if co_dispatch is not None and co_dispatch < 0:
            raise ValueError(f"co_dispatch must be >= 0 or None "
                             f"(got {co_dispatch})")
        self.co_dispatch = co_dispatch
        if burst < 1:
            raise ValueError(f"burst must be >= 1 (got {burst})")
        self.burst = burst
        self.pool = pool
        self._slot = 0
        self._dispatches = 0
        # execution back end: step() compiles each slot's decisions into
        # instructions and the executor runs them (and records the
        # executed stream — ``self.stream``); a MultiPoolRouter re-homes
        # this executor to give it a pool name and SEND/RECV transport
        self.executor = PoolExecutor(self)
        # closed-loop controller (fleet.control.ControlLoop attaches
        # itself here); consulted once per executed slot — its actions
        # inject SET_PARAM/REBALANCE into the recorded stream, so a
        # controlled run replays with no controller attached
        self.controller = None

    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        """True while any member holds queued or in-flight work."""
        return any(m.engine.has_work for m in self.members)

    @property
    def in_flight(self) -> int:
        """Total admitted requests across members."""
        return sum(m.engine.in_flight for m in self.members)

    @property
    def queued(self) -> int:
        """Total queued (unadmitted) requests across members."""
        return sum(m.engine.queued for m in self.members)

    # ------------------------------------------------------------------
    def submit(self, request: Request | object) -> Ticket:
        """Route on the model tag into the member's own queue.  A full
        member queue raises ``QueueFull`` *before* any fleet bookkeeping,
        leaving the other members' traffic untouched."""
        req = request if isinstance(request, Request) else Request(request)
        name = self.router.route(req)
        member = self._by_name[name]
        submitted_at = time.perf_counter()
        obs = self.executor.obs
        try:
            mticket = member.engine.submit(
                Request(payload=req.payload, gen_steps=req.gen_steps,
                        model=name, deadline=req.deadline,
                        priority=req.priority))
        except QueueFull:
            # refusals depend on the caller's retry cadence, not the
            # stream — wall domain (successful admissions are slot:
            # replay re-submits them at their placement watermarks)
            obs.counter("serve_queue_full_total",
                        "submissions refused by a full member queue",
                        "wall").inc(labels={"pool": self.executor.name,
                                            "model": name})
            raise
        obs.counter("serve_requests_total",
                    "requests admitted into member queues", "slot").inc(
            labels={"pool": self.executor.name, "model": name})
        obs.gauge("serve_queue_depth", "queued requests across members",
                  "slot").set(self.queued,
                              labels={"pool": self.executor.name})
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid                    # the engine contract: rid is
        #                                  stamped on the caller's request
        self._metrics[rid] = RequestMetrics(rid=rid,
                                            submitted_at=submitted_at,
                                            model=name)
        self._order.append(rid)
        member.rid_map[mticket.rid] = rid
        return Ticket(rid=rid, submitted_at=submitted_at)

    # ------------------------------------------------------------------
    def _views(self) -> list[MemberView]:
        # head_deadline costs an O(queue) scan per member per slot and
        # next_core a walk over the in-flight groups — pay them only when
        # something reads them (a deadline-aware policy; co-dispatch
        # ordering), not on every slot of every policy.  The views are
        # made by ``fleet.compiler.observe`` so the AOT compiler's member
        # mirrors feed the policy identical inputs.
        want_deadlines = getattr(self.policy, "uses_deadlines", False)
        want_cores = self.co_dispatch is None or self.co_dispatch > 0
        views = (observe(i, m.name, m.engine, weight=m.weight,
                         dispatches=m.dispatches,
                         want_deadlines=want_deadlines,
                         want_cores=want_cores)
                 for i, m in enumerate(self.members))
        return [v for v in views if v is not None]

    @property
    def stream(self):
        """The instruction stream executed so far (``ExecRecord`` list) —
        serialize with ``instructions.stream_to_json``, replay with
        ``executor.PoolExecutor.replay``."""
        return self.executor.records

    def step(self) -> list[Completion]:
        """One fleet slot, as compile-then-execute: lower this slot's
        scheduling decisions (policy primary first, then up to
        ``co_dispatch`` members core-complementary-first, ``burst`` deep,
        every RUN before any FREE — module docstring points 2-4) into
        instructions, and replay them through the executor.  The executed
        stream accumulates on :attr:`stream`; a stream compiled ahead of
        time for the same arrivals replays to the same trace bitwise
        (``compiler.compile_fleet``, tested)."""
        self._start_clock()
        views = self._views()
        if not views:
            return []
        compiler = SlotCompiler(self.policy, co_dispatch=self.co_dispatch,
                                burst=self.burst)
        instrs = compiler.lower_slot(views, self._dispatches)
        done = self.executor.execute_slot(instrs, self._slot)
        self._slot += 1
        if self.controller is not None:
            self.controller.on_slot(done)
        return done

    def withdraw_pending(self, max_n: int | None = None, *,
                         member: str | None = None
                         ) -> list[tuple[int, Request]]:
        """Remove up to ``max_n`` queued (unadmitted) requests from the
        member queues — all members, or just ``member`` — un-accounting
        them at both the member and fleet boundary.  Returns
        ``(fleet rid, request)`` pairs; the SEND instruction (cross-pool
        migration) is the caller."""
        names = ([member] if member is not None
                 else [m.name for m in self.members])
        out: list[tuple[int, Request]] = []
        for name in names:
            if name not in self._by_name:
                raise KeyError(f"no member {name!r} "
                               f"(members: {[m.name for m in self.members]})")
            if max_n is not None and len(out) >= max_n:
                break
            m = self._by_name[name]
            take = None if max_n is None else max_n - len(out)
            for mrid, req in m.engine.withdraw_pending(take):
                frid = m.rid_map.pop(mrid)
                del self._metrics[frid]
                self._order.remove(frid)
                req.rid = None
                req.model = name        # keep the route after migration
                out.append((frid, req))
        return out

    def _adopt(self, member: Member, c: Completion) -> Completion:
        """Re-account a member completion at the fleet boundary: fleet
        rid and submit time, member start/finish stamps, no re-blocking
        (the member already materialized the output)."""
        frid = member.rid_map.pop(c.ticket.rid)
        m = self._metrics[frid]
        m.started_at = c.metrics.started_at
        m.finished_at = c.metrics.finished_at
        m.slo_ok = c.metrics.slo_ok
        m.deadline = c.metrics.deadline
        if c.metrics.status != "ok":    # shed/failed win; "ok" never
            m.status = c.metrics.status     # downgrades a prior status
        fc = Completion(ticket=Ticket(rid=frid,
                                      submitted_at=m.submitted_at),
                        output=c.output, metrics=m)
        self._completions[frid] = fc
        return fc

    # ------------------------------------------------------------------
    def _extra_stats(self, metrics: Metrics) -> dict:
        per_member = {}
        for m in self.members:
            done = [r for r in metrics.requests if r.model == m.name]
            per_member[m.name] = {
                "weight": m.weight,
                "dispatches": m.dispatches,
                "completed": len(done),
                "queued": m.engine.queued,
                "in_flight": m.engine.in_flight,
            }
        out = {"engine": "fleet",
               "policy": type(self.policy).__name__,
               "co_dispatch": self.co_dispatch,
               "burst": self.burst,
               "slots": self._slot,
               "dispatches": self._dispatches,
               "aggregate_fps": metrics.requests_per_s(),
               "goodput_fps": metrics.goodput_fps(),
               "per_member": per_member,
               "per_model": metrics.by_model()}
        if self.pool is not None:
            out["pool"] = self.pool.stats()
        if self.controller is not None:
            out["control"] = self.controller.stats()
        return out


# --------------------------------------------------------------------------
# fleet assembly
# --------------------------------------------------------------------------
def build_cnn_fleet(models: Sequence[str], *,
                    pool: DevicePool | None = None,
                    device: str | torch.device = "cuda",
                    theta: float = 0.5,
                    scheme: str = "balanced",
                    plan=None,
                    fuse: bool | str = "group",
                    seed: int = 0,
                    policy: SchedulingPolicy | None = None,
                    weights: Mapping[str, float] | None = None,
                    admission: Mapping[str, AdmissionPolicy] | None = None,
                    max_queue: int | None = None,
                    co_dispatch: int | None = None,
                    burst: int = 1,
                    jit_groups: bool = True,
                    ) -> tuple[FleetEngine, DevicePool]:
    """Stand up a CNN fleet: one shared :class:`DevicePool` on ``device``
    (the card unless the caller passes ``device="cpu"``), one
    ``DualCoreRunner`` + ``DualCoreEngine`` per model, each leasing the
    pool's c/p split, wrapped in a :class:`FleetEngine`.  Weights are the
    seeded He-init of ``build_model(model, seed)``.

    ``plan`` (a ``fleet.planner.FleetPlan``) supplies the co-scheduled
    PE config, per-model schedules and mix weights; without one, every
    model is scheduled under ``DUAL_BASELINE`` with ``scheme``
    (``"best"`` runs the full §V-A flow per model).  ``jit_groups`` goes
    to every member's runner (compiled exec groups on the card; see
    ``DualCoreRunner``).  The pool made here splits the card's SMs; pass
    ``pool=DevicePool(device, sm_split=False)`` for two streams on every SM,
    the baseline.
    """
    board = BoardModel()
    if pool is None:
        # a plan's theta is part of the planned configuration: the pool
        # split must record it, not the default
        pool = DevicePool(device,
                          theta=plan.theta if plan is not None else theta)
    elif plan is not None and abs(pool.theta - plan.theta) > 1e-9:
        raise ValueError(
            f"pool theta={pool.theta} contradicts the plan's "
            f"theta={plan.theta:.4f}; serving a planned configuration on "
            f"a different split would invalidate the predicted-vs-measured "
            f"comparison")
    if plan is not None and weights is None:
        weights = plan.mix
    members: dict[str, DualCoreEngine] = {}
    for model in models:
        params, _, graph = build_model(model, seed=seed, device=pool.device)
        if plan is not None:
            cfg = plan.config
            sched = plan.schedules[model]
        else:
            cfg = DUAL_BASELINE
            sched = (best_schedule(graph, cfg, board)
                     if scheme == "best"
                     else build_schedule(graph, cfg, board, scheme))
        runner = DualCoreRunner(model, params, sched, device=pool.device,
                                fuse=fuse, cores=pool.lease(model),
                                jit_groups=jit_groups)
        members[model] = DualCoreEngine(runner, max_queue=max_queue)
    engine = FleetEngine(members, policy=policy, weights=weights,
                         admission=admission, co_dispatch=co_dispatch,
                         burst=burst, pool=pool)
    return engine, pool
