"""Seeded, deterministic fault injection for fleet serving (DESIGN.md §12).

The fleet runtime executes everything through instruction streams
(:mod:`repro_torch.fleet.instructions`), which gives failures a natural unit:
the instruction boundary.  A :class:`FaultPlan` is a list of
:class:`Fault` declarations — *this pool's RUN raises*, *this pool dies
at slot k*, *this SEND is lost in transit*, *this pool runs slow* — and a
:class:`FaultInjector` arms the plan inside ``PoolExecutor.execute``:
before any engine state moves, the executor asks the injector whether
this ``(pool, instruction, slot)`` boundary fails.  Because injection
happens strictly before execution, a retried instruction re-executes
against an unchanged pool, and because every fault fires as a pure
function of the boundary (no RNG at fire time), a faulted run is exactly
reproducible: re-running the same plan against the same arrival trace
produces the same failures, the same recoveries, and the same recorded
streams.

Fault kinds and what recovers them:

  ``run_error``   a RUN raises :class:`InjectedFault` ``times``
                  consecutive attempts — recovered by the executor's
                  bounded retry (``RecoveryConfig.max_retries``); retries
                  exhausted escalate to :class:`PoolCrash`.
  ``pool_crash``  the pool raises :class:`PoolCrash` at the first
                  instruction boundary at/after ``slot`` — recovered by
                  ``MultiPoolRouter`` crash recovery (un-retired requests
                  reconstructed from the placement log and re-routed to
                  surviving pools).
  ``send_drop``   one SEND's payloads vanish in transit — recovered by
                  the router re-routing the in-transit requests from its
                  journal.
  ``latency``     every RUN on the pool sleeps ``skew_s`` (a slow host)
                  — detected by the per-RUN timeout
                  (``RecoveryConfig.run_timeout_s``); ``timeout_strikes``
                  timeouts degrade the pool (drained, no new placements).

``FaultPlan.generate(seed, ...)`` draws a random plan from a seeded
generator — the property tests sweep seeds and assert every faulted run
replays bitwise from its recorded streams + recovery log.

Copy of ``repro/fleet/faults.py``: a plan document (FaultPlan v1) written
by either package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import random
import time
from typing import Sequence

FAULT_KINDS = ("run_error", "pool_crash", "send_drop", "latency")


class InjectedFault(RuntimeError):
    """A recoverable injected failure at one instruction boundary (the
    executor retries the instruction, bounded by ``RecoveryConfig``)."""


class PoolCrash(RuntimeError):
    """A pool died: either an injected ``pool_crash`` fault or an
    injected RUN failure that exhausted its retries.  The pool executes
    nothing further; ``MultiPoolRouter`` recovers its un-retired
    requests onto surviving pools."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One declared failure.

    kind     one of :data:`FAULT_KINDS`
    pool     the pool it arms on
    slot     first fleet slot at/after which it can fire
    member   ``run_error`` only: restrict to one member's RUNs (None =
             any RUN on the pool)
    times    ``run_error`` only: consecutive attempts that fail before
             the RUN succeeds (> max_retries escalates to a crash)
    skew_s   ``latency`` only: seconds each RUN on the pool sleeps
    """

    kind: str
    pool: str = "pool0"
    slot: int = 0
    member: str | None = None
    times: int = 1
    skew_s: float = 0.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")
        if self.slot < 0:
            raise ValueError(f"fault slot must be >= 0 (got {self.slot})")
        if self.times < 1:
            raise ValueError(f"fault times must be >= 1 (got {self.times})")
        if self.kind == "latency" and not self.skew_s > 0:
            raise ValueError(f"latency fault needs skew_s > 0 "
                             f"(got {self.skew_s})")


@dataclasses.dataclass
class FaultPlan:
    """A reproducible failure scenario: an ordered list of faults plus
    the seed that generated it (None for hand-written plans).  JSON
    round-trips via :meth:`to_json` / :meth:`from_json` — the ``serve
    fleet --faults PLAN.json`` format."""

    faults: tuple[Fault, ...] = ()
    seed: int | None = None

    def __post_init__(self):
        self.faults = tuple(self.faults)

    def to_json(self) -> dict:
        """Serialize to the ``--faults PLAN.json`` document format."""
        return {"version": 1, "seed": self.seed,
                "faults": [dataclasses.asdict(f) for f in self.faults]}

    @classmethod
    def from_json(cls, doc: dict) -> "FaultPlan":
        """Parse a plan document; unknown versions or fields raise."""
        if not isinstance(doc, dict):
            raise ValueError(f"a fault plan is a JSON object "
                             f"(got {type(doc).__name__})")
        version = doc.get("version")
        if version != 1:
            raise ValueError(f"fault plan version {version!r} != "
                             f"supported 1")
        raw = doc.get("faults")
        if not isinstance(raw, list):
            raise ValueError("fault plan needs a 'faults' list")
        fields = {f.name for f in dataclasses.fields(Fault)}
        faults = []
        for i, d in enumerate(raw):
            if not isinstance(d, dict):
                raise ValueError(f"fault {i} is not an object: {d!r}")
            unknown = set(d) - fields
            if unknown:
                raise ValueError(f"fault {i} has unknown fields "
                                 f"{sorted(unknown)} (expected a subset "
                                 f"of {sorted(fields)})")
            faults.append(Fault(**d))
        return cls(faults=tuple(faults), seed=doc.get("seed"))

    def dump(self, path: str) -> None:
        """Write :meth:`to_json` to ``path``."""
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        """Read and validate a plan written by :meth:`dump`."""
        with open(path) as f:
            try:
                doc = json.load(f)
            except json.JSONDecodeError as e:
                raise ValueError(f"fault plan {path!r} is not valid "
                                 f"JSON: {e}") from e
        return cls.from_json(doc)

    @classmethod
    def generate(cls, seed: int, *, pools: Sequence[str],
                 members: Sequence[str] = (), n: int = 3,
                 max_slot: int = 10,
                 allow_total_crash: bool = False) -> "FaultPlan":
        """Draw a random plan from a seeded generator: up to ``n``
        faults over the given pools (and members, for run_error
        targeting).  At most ``len(pools) - 1`` pool crashes unless
        ``allow_total_crash`` — a scenario with no survivor fails every
        request instead of recovering, which is reproducible too but
        rarely what a chaos sweep wants."""
        rng = random.Random(seed)
        pools = list(pools)
        crash_budget = (len(pools) if allow_total_crash
                        else max(0, len(pools) - 1))
        crashed: list[str] = []
        faults: list[Fault] = []
        for _ in range(rng.randint(1, max(1, n))):
            kind = rng.choice(FAULT_KINDS)
            pool = rng.choice(pools)
            slot = rng.randint(0, max_slot)
            if kind == "pool_crash":
                if len(crashed) >= crash_budget or pool in crashed:
                    kind = "run_error"
                else:
                    crashed.append(pool)
            if kind == "run_error":
                member = (rng.choice(list(members))
                          if members and rng.random() < 0.5 else None)
                faults.append(Fault(kind=kind, pool=pool, slot=slot,
                                    member=member,
                                    times=rng.randint(1, 2)))
            elif kind == "pool_crash":
                faults.append(Fault(kind=kind, pool=pool, slot=slot))
            elif kind == "send_drop":
                faults.append(Fault(kind=kind, pool=pool, slot=slot))
            else:
                faults.append(Fault(kind=kind, pool=pool, slot=slot,
                                    skew_s=rng.uniform(0.001, 0.005)))
        return cls(faults=tuple(faults), seed=seed)


@dataclasses.dataclass
class RecoveryConfig:
    """How the executor and router respond to failures.

    max_retries        attempts re-issued for a RUN that raised an
                       :class:`InjectedFault` before escalating to
                       :class:`PoolCrash`
    backoff_s          base of the exponential retry backoff (0 = retry
                       immediately; tests and replays want 0)
    run_timeout_s      RUN wall time beyond which the executor counts a
                       timeout (None = never) — detection for latency
                       skew, since synchronous execution cannot abort a
                       RUN that already completed
    timeout_strikes    timeouts on one pool before the router degrades
                       it: drains its queue to a sibling and stops
                       placing new requests on it
    rebalance_on_crash re-plan theta on the surviving pool after a crash
                       (skipped automatically for fleets with no
                       DevicePool)
    heartbeat_s        fleets across processes only: the read deadline
                       on every coordinator->worker RPC; a worker silent
                       past it is declared crashed (None = wait forever)
    """

    max_retries: int = 2
    backoff_s: float = 0.0
    run_timeout_s: float | None = None
    timeout_strikes: int = 3
    rebalance_on_crash: bool = True
    heartbeat_s: float | None = 30.0

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0 "
                             f"(got {self.max_retries})")
        if self.backoff_s < 0:
            raise ValueError(f"backoff_s must be >= 0 "
                             f"(got {self.backoff_s})")
        if self.run_timeout_s is not None and not self.run_timeout_s > 0:
            raise ValueError(f"run_timeout_s must be > 0 or None "
                             f"(got {self.run_timeout_s})")
        if self.timeout_strikes < 1:
            raise ValueError(f"timeout_strikes must be >= 1 "
                             f"(got {self.timeout_strikes})")
        if self.heartbeat_s is not None and not self.heartbeat_s > 0:
            raise ValueError(f"heartbeat_s must be > 0 or None "
                             f"(got {self.heartbeat_s})")


class FaultInjector:
    """Arms a :class:`FaultPlan` at instruction boundaries.

    ``before(pool, instr, slot)`` is called by ``PoolExecutor.execute``
    before any engine state moves; it raises :class:`InjectedFault` /
    :class:`PoolCrash` or sleeps (latency skew) per the plan.
    ``drops_send(pool, slot)`` is consulted at SEND boundaries.  Firing
    is deterministic — each fault tracks how often it has fired, never a
    random draw — so the same plan against the same stream fails
    identically every run."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.fired = [0] * len(plan.faults)

    def before(self, pool: str, instr, slot: int) -> None:
        """Fire any armed fault at this instruction boundary (called per
        executed instruction)."""
        op = getattr(instr, "op", None)
        for i, f in enumerate(self.plan.faults):
            if f.pool != pool or slot < f.slot:
                continue
            if f.kind == "pool_crash":
                if self.fired[i] == 0:
                    self.fired[i] += 1
                    raise PoolCrash(f"injected crash of pool {pool!r} at "
                                    f"slot {slot} (fault {i})")
            elif f.kind == "run_error" and op == "RUN":
                if f.member is not None and instr.member != f.member:
                    continue
                if self.fired[i] < f.times:
                    self.fired[i] += 1
                    raise InjectedFault(
                        f"injected RUN failure on pool {pool!r} member "
                        f"{instr.member!r} at slot {slot} "
                        f"(fault {i}, firing {self.fired[i]}/{f.times})")
            elif f.kind == "latency" and op == "RUN":
                self.fired[i] += 1
                time.sleep(f.skew_s)

    def drops_send(self, pool: str, slot: int) -> bool:
        """True exactly once per armed send_drop fault on this pool."""
        for i, f in enumerate(self.plan.faults):
            if (f.kind == "send_drop" and f.pool == pool
                    and slot >= f.slot and self.fired[i] == 0):
                self.fired[i] += 1
                return True
        return False

    def summary(self) -> dict:
        """Per-fault fire counts, for bench reports and run summaries."""
        return {"seed": self.plan.seed,
                "faults": [{"kind": f.kind, "pool": f.pool,
                            "slot": f.slot, "fired": n}
                           for f, n in zip(self.plan.faults, self.fired)]}
