"""Request routing and cross-engine step scheduling for the fleet.

Two decisions live here, both pluggable and both *outside* the member
engines (which stay single-network and unchanged):

  * **Routing** — which member serves a request.  Requests carry a
    ``model`` tag (``serving.api.Request.model``); the :class:`Router`
    maps tags to members and rejects unknown tags loudly.  A single-member
    fleet accepts untagged requests (there is only one place to go).

  * **Step scheduling** — which member's exec group the fleet dispatches
    next.  Every ``FleetEngine.step`` asks the :class:`SchedulingPolicy`
    to pick ONE primary member from the members that currently have work;
    the engine may then co-dispatch a second, core-complementary member
    (that part uses the latency model, see ``fleet.engine``).  Policies
    see a :class:`MemberView` per member — queue depth, in-flight count,
    traffic weight, dispatch deficit, earliest pending deadline, and the
    predicted dominant core — and nothing else, so they compose with any
    engine implementing the serving protocol.

Policies:

  round_robin     cycle through members with work (stateless fairness)
  shortest_queue  least outstanding work first — keeps lightly-loaded
                  models' latency low (SJF flavor across networks)
  weighted_fair   largest dispatch deficit vs the traffic mix first
                  (weight w_m entitles a member to a w_m share of fleet
                  steps; deficit = entitlement - dispatches received)
  deadline_edf    earliest pending deadline first (requests without a
                  deadline sort last); FIFO tie-break by member order

Copy of ``repro/fleet/router.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import dataclasses
from typing import Protocol, Sequence, runtime_checkable

from repro_torch.serving.api import Request

POLICY_NAMES = ("round_robin", "shortest_queue", "weighted_fair",
                "deadline_edf")


@dataclasses.dataclass
class MemberView:
    """What a scheduling policy may observe about one member."""

    index: int                      # position in the fleet's member order
    name: str                       # model tag the member serves
    queued: int
    in_flight: int
    weight: float                   # traffic-mix share (normalized)
    dispatches: int                 # fleet steps this member has received
    head_deadline: float | None     # earliest deadline among queued reqs
    next_core: str | None           # 'c' | 'p' dominant core next step
    has_work: bool
    batched: bool = True            # has the advance/retire split (a RUN
    #                                 can defer its FREE); False = opaque,
    #                                 step() fuses dispatch and block

    @property
    def outstanding(self) -> int:
        """Queued plus in-flight work owned by this member."""
        return self.queued + self.in_flight


@runtime_checkable
class SchedulingPolicy(Protocol):
    """Picks which member the fleet steps next."""

    def pick(self, views: Sequence[MemberView],
             total_dispatches: int) -> int:
        """Return the ``index`` of the member to step.  ``views`` contains
        only members with work (never empty); ``total_dispatches`` is the
        fleet-wide step count so far (for deficit bookkeeping)."""
        ...


@dataclasses.dataclass
class RoundRobin:
    """Cycle through members with work, resuming after the last pick."""

    _last: int = -1

    def pick(self, views: Sequence[MemberView],
             total_dispatches: int) -> int:
        """Pick the first member with work after the last pick."""
        after = [v for v in views if v.index > self._last]
        v = (after or views)[0]
        self._last = v.index
        return v.index


@dataclasses.dataclass
class ShortestQueue:
    """Least outstanding (queued + in-flight) work first."""

    def pick(self, views: Sequence[MemberView],
             total_dispatches: int) -> int:
        """Pick the member with the least outstanding work."""
        return min(views, key=lambda v: (v.outstanding, v.index)).index


@dataclasses.dataclass
class WeightedFair:
    """Largest deficit vs the traffic mix: member m is entitled to
    ``w_m / sum(w)`` of all fleet steps; the member furthest below its
    entitlement goes next.  With equal weights this degrades to
    round-robin-like fairness; with a skewed mix, dispatch counts track
    the mix (a test drives this under skewed Poisson arrivals)."""

    def pick(self, views: Sequence[MemberView],
             total_dispatches: int) -> int:
        """Pick the member furthest below its weighted entitlement."""
        wsum = sum(v.weight for v in views)

        def deficit(v: MemberView) -> float:
            # all-zero weights degrade to equal shares, not index order
            share = v.weight / wsum if wsum > 0 else 1.0 / len(views)
            return share * (total_dispatches + 1) - v.dispatches

        return max(views, key=lambda v: (deficit(v), -v.index)).index


@dataclasses.dataclass
class DeadlineEDF:
    """Earliest pending deadline across members first; members whose head
    request has no deadline sort last (then FIFO by member order).  Pair
    with a per-member ``DeadlineAdmission`` so the member also admits its
    own queue in EDF order — fleet-level EDF picks the member, member-level
    EDF picks the request."""

    # tells the fleet to pay the per-slot pending-queue deadline scan;
    # policies without this flag get head_deadline=None for free
    uses_deadlines = True

    def pick(self, views: Sequence[MemberView],
             total_dispatches: int) -> int:
        """Pick the member whose head request expires first."""
        return min(views,
                   key=lambda v: (v.head_deadline is None,
                                  v.head_deadline
                                  if v.head_deadline is not None else 0.0,
                                  v.index)).index


def make_policy(name: str) -> SchedulingPolicy:
    """Policy registry for the CLI / bench (``POLICY_NAMES``)."""
    try:
        return {"round_robin": RoundRobin,
                "shortest_queue": ShortestQueue,
                "weighted_fair": WeightedFair,
                "deadline_edf": DeadlineEDF}[name]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"one of {POLICY_NAMES}") from None


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------
class Router:
    """Model-tag -> member routing table.

    The router also tallies arrivals per member (:attr:`routed`, counted
    at route time, before any admission decision) — the fleet's
    arrival-side view of the traffic mix, which the §13 control loop
    would diff between observations to estimate the live qps mix.  Queue
    depth alone cannot distinguish "more arrivals" from "slower
    service"; the arrival tally can.
    """

    def __init__(self, names: Sequence[str]):
        """Build the table over member ``names`` (model tags)."""
        if not names:
            raise ValueError("a fleet needs at least one member")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate member names: {list(names)}")
        self.names = list(names)
        self.routed: dict[str, int] = {n: 0 for n in self.names}

    def route(self, request: Request) -> str:
        """Member name serving this request's model tag.  Untagged
        requests are only routable in a single-member fleet."""
        if request.model is None:
            if len(self.names) == 1:
                self.routed[self.names[0]] += 1
                return self.names[0]
            raise KeyError(f"untagged request in a {len(self.names)}-member "
                           f"fleet; set Request.model to one of "
                           f"{self.names}")
        if request.model not in self.names:
            raise KeyError(f"no member serves model {request.model!r} "
                           f"(members: {self.names})")
        self.routed[request.model] += 1
        return request.model
