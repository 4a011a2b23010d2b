"""Closed-loop SLO adaptation for fleet serving.

Port of ``repro/fleet/control.py``.  Deadline shedding and goodput
accounting handle an SLO only in the open: weights, theta and the LM
fusion width stay as planned, so a drifting traffic mix could only shed
its way back under the SLO.  :class:`ControlLoop` closes the loop: every
``interval`` fleet slots it observes a sliding window of per-model
completions (:class:`~repro_torch.serving.api.MetricsWindow` p95 + shed
rate, queue depth, and the router's arrival tallies) and emits typed
:data:`ControlAction`\\ s:

  ================  =====================================================
  action            trigger -> lowering
  ================  =====================================================
  Reweight          window arrival mix drifts > ``reweight_deadband``
                    (total-variation) from the members' normalized
                    weights -> one ``SET_PARAM(member, "weight", share)``
                    per member, snapping weighted-fair entitlements to
                    the observed mix
  Retune            a retunable member's window p95 breaches
                    ``band[1] * slo_ms`` -> ``SET_PARAM(member,
                    "group_size", width // 2)`` (smaller fusion width =
                    lower queueing delay per admitted stream); once
                    breached, p95 back under ``band[0] * slo_ms`` widens
                    it again toward the configured width (the two-band
                    rule is the hysteresis)
  RebalanceTheta    aggregate window shed rate > ``shed_high`` for
                    ``sustain`` consecutive observations ->
                    ``REBALANCE(theta)`` re-planned for the observed
                    mix; the trigger re-arms only after the rate falls
                    below ``shed_low`` (hysteresis), and ``cooldown``
                    observations must pass after *any* REBALANCE (the
                    controller's own or a recovery's) before another
                    fires (the recovery interlock)
  ================  =====================================================

On the card a REBALANCE re-splits the pool's SMs between the c-core and
the p-core at the new theta (two new green contexts unless that count's
split was made before) and every member captures new graphs in the new
partitions.  ``RebalanceTheta`` re-plans inline: ``planner.plan_fleet``
runs its host search in the middle of the fleet slot, and the slot loop
waits for it.

Actions lower through the instruction stream (``executor.inject``), so a
controlled run replays bitwise from its recorded stream with **no
controller attached**: the mutations are instructions, not side effects.
Each emitted action is also appended to :attr:`decisions`, a
seq-watermarked decision log (the audit trail binding every injected
instruction to the window stats that motivated it), serializable via
:func:`decisions_to_json` and checkable against a stream via
:func:`verify_decisions`.  The log (version 1) is byte-compatible with
the reference's: a log written by either package loads and verifies on
the other.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Sequence

from repro_torch.fleet.instructions import (ExecRecord, Instruction,
                                            Rebalance, SetParam)
from repro_torch.serving.api import Completion, MetricsWindow


# --------------------------------------------------------------------------
# typed actions
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Reweight:
    """Set one member's fleet weight share toward the observed mix."""

    member: str
    weight: float

    kind = "reweight"


@dataclasses.dataclass(frozen=True)
class Retune:
    """Set one retunable engine knob (e.g. the LM ``group_size``)."""

    member: str
    param: str
    value: int

    kind = "retune"


@dataclasses.dataclass(frozen=True)
class RebalanceTheta:
    """Re-lease the pool's c/p split at a newly planned theta."""

    theta: float

    kind = "rebalance"


Action = Reweight | Retune | RebalanceTheta

#: what a ControlLoop emits (alias kept for the public API surface)
ControlAction = Action

_KIND_TYPES = {"reweight": Reweight, "retune": Retune,
               "rebalance": RebalanceTheta}


def lower_action(action: Action) -> Instruction:
    """Lower one control action to its fleet instruction."""
    if isinstance(action, Reweight):
        return SetParam(member=action.member, param="weight",
                        value=float(action.weight))
    if isinstance(action, Retune):
        return SetParam(member=action.member, param=action.param,
                        value=action.value)
    if isinstance(action, RebalanceTheta):
        return Rebalance(theta=action.theta)
    raise TypeError(f"unknown control action {action!r}")


# --------------------------------------------------------------------------
# the decision log
# --------------------------------------------------------------------------
DECISION_LOG_VERSION = 1


@dataclasses.dataclass
class Decision:
    """One emitted action: its stream position and its evidence.

    ``seq`` is the stream sequence number of the instruction the action
    lowered to (captured as the watermark at injection), ``slot`` the
    fleet slot it was injected at, ``reason`` a human-readable trigger
    description, and ``observed`` the compact window-stats snapshot that
    motivated it.  The stream alone replays the run; the decision log is
    the audit trail tying each injected instruction back to *why*.
    """

    seq: int
    slot: int
    action: Action
    reason: str
    observed: dict = dataclasses.field(default_factory=dict)


def decisions_to_json(decisions: Sequence[Decision]) -> dict:
    """Serialize a decision log (versioned, like the instruction schema)."""
    return {
        "version": DECISION_LOG_VERSION,
        "decisions": [{
            "seq": d.seq,
            "slot": d.slot,
            "kind": d.action.kind,
            "action": dataclasses.asdict(d.action),
            "reason": d.reason,
            "observed": d.observed,
        } for d in decisions],
    }


def decisions_from_json(doc: dict) -> list[Decision]:
    """Deserialize a decision log; unknown versions/kinds are hard errors."""
    version = doc.get("version")
    if version != DECISION_LOG_VERSION:
        raise ValueError(f"decision log version {version!r} != supported "
                         f"{DECISION_LOG_VERSION}")
    out = []
    for d in doc["decisions"]:
        kind = d.get("kind")
        if kind not in _KIND_TYPES:
            raise ValueError(f"unknown decision kind {kind!r}; one of "
                             f"{sorted(_KIND_TYPES)}")
        out.append(Decision(seq=d["seq"], slot=d["slot"],
                            action=_KIND_TYPES[kind](**d["action"]),
                            reason=d.get("reason", ""),
                            observed=d.get("observed", {})))
    return out


def dump_decisions(decisions: Sequence[Decision], path: str) -> None:
    """Write a decision log next to its streams (JSON)."""
    with open(path, "w") as f:
        json.dump(decisions_to_json(decisions), f, indent=1)


def load_decisions(path: str) -> list[Decision]:
    """Read a decision log written by :func:`dump_decisions`."""
    with open(path) as f:
        return decisions_from_json(json.load(f))


def verify_decisions(records: Sequence[ExecRecord],
                     decisions: Sequence[Decision]) -> None:
    """Check a decision log against the stream it annotates.

    Every decision must point (by ``seq``) at a record whose instruction
    is exactly the decision's action lowered — the invariant that makes
    the log an audit trail of the stream rather than a parallel story.
    Raises ``ValueError`` on any mismatch.
    """
    by_seq = {r.seq: r for r in records}
    for d in decisions:
        r = by_seq.get(d.seq)
        if r is None:
            raise ValueError(f"decision at seq {d.seq} has no matching "
                             f"stream record")
        want = lower_action(d.action)
        if r.instr != want:
            raise ValueError(f"decision at seq {d.seq} lowered to {want!r} "
                             f"but the stream recorded {r.instr!r}")


# --------------------------------------------------------------------------
# the control loop
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Observation:
    """One observation-window snapshot the controller decides from."""

    slot: int
    arrivals: dict[str, int]            # router arrivals since last obs
    queued: dict[str, int]              # per-member queue depth now
    window: dict[str, dict]             # MetricsWindow.by_model()
    shed_rate: float                    # aggregate over the window
    weights: dict[str, float]           # current normalized weights

    def mix(self) -> dict[str, float]:
        """Observed traffic mix: arrival shares this interval, empty when
        nothing arrived.  Deliberately arrival-only — during the drain
        tail the completion mix reflects leftover queue composition, and
        reweighting toward *that* would chase the backlog instead of the
        traffic."""
        total = sum(self.arrivals.values())
        if total > 0:
            return {m: n / total for m, n in self.arrivals.items() if n}
        return {}


def _tv(a: dict[str, float], b: dict[str, float]) -> float:
    """Total-variation distance between two normalized mixes."""
    return 0.5 * sum(abs(a.get(k, 0.0) - b.get(k, 0.0))
                     for k in set(a) | set(b))


class ControlLoop:
    """Closed-loop fleet controller (module docstring for the rules).

    fleet              the ``FleetEngine`` to control; the loop attaches
                       itself as ``fleet.controller`` and is consulted
                       once per executed slot
    interval           fleet slots between observations (K)
    window             completions the sliding window holds
    slo_ms             per-request latency SLO the retune rule guards
                       (None disables retuning)
    band               (low, high) fractions of ``slo_ms``: p95 above
                       high*slo breaches, below low*slo recovers — the
                       gap is the retune hysteresis
    reweight_deadband  total-variation distance between observed mix and
                       current weights below which no reweight fires
                       (the reweight hysteresis)
    shed_high          window shed rate that (sustained) triggers a
                       REBALANCE
    shed_low           rate below which the shed trigger re-arms
    sustain            consecutive over-``shed_high`` observations needed
                       to fire
    cooldown           observations after *any* REBALANCE (controller's
                       or §12 recovery's) before another may fire
    plan_evals         search budget for ``planner.plan_fleet`` when
                       re-planning theta
    min_group          floor for group_size halving (default 1)
    """

    def __init__(self, fleet, *, interval: int = 8, window: int = 64,
                 slo_ms: float | None = None,
                 band: tuple[float, float] = (0.5, 1.0),
                 reweight_deadband: float = 0.15,
                 shed_high: float = 0.25, shed_low: float = 0.05,
                 sustain: int = 2, cooldown: int = 4,
                 plan_evals: int = 4, min_group: int = 1):
        if interval < 1:
            raise ValueError(f"interval must be >= 1 (got {interval})")
        if not 0.0 <= band[0] <= band[1]:
            raise ValueError(f"band must be 0 <= low <= high (got {band})")
        if not 0.0 <= shed_low <= shed_high <= 1.0:
            raise ValueError(f"need 0 <= shed_low <= shed_high <= 1 "
                             f"(got {shed_low}, {shed_high})")
        self.fleet = fleet
        self.interval = interval
        self.window = MetricsWindow(window)
        self.slo_ms = slo_ms
        self.band = band
        self.reweight_deadband = reweight_deadband
        self.shed_high = shed_high
        self.shed_low = shed_low
        self.sustain = max(1, sustain)
        self.cooldown = cooldown
        self.plan_evals = plan_evals
        self.min_group = max(1, min_group)
        self.decisions: list[Decision] = []
        self.observations = 0
        # --- hysteresis / cooldown state --------------------------------
        self._last_routed: dict[str, int] = {}
        self._breached: set[str] = set()        # members in p95 breach
        self._configured: dict[str, int] = {}   # member -> original width
        self._shed_streak = 0
        self._shed_armed = True
        self._cooldown_left = 0
        self._seen_seq = 0      # stream watermark of the §12 scan
        fleet.controller = self

    # ------------------------------------------------------------------
    def on_slot(self, completions: Sequence[Completion]) -> None:
        """Per-slot hook ``FleetEngine.step`` calls after executing.

        Feeds the window every slot; every ``interval``-th slot it
        observes, decides, and injects the resulting instructions.
        Actions are only emitted while the fleet still has work — a
        trailing injected instruction would never execute in replay,
        breaking the stream-covers-the-run invariant.
        """
        self.window.observe(completions)
        if self.fleet._slot % self.interval != 0:
            return
        if not self.fleet.has_work:
            return
        obs = self.observe()
        for action, reason in self.decide(obs):
            self._apply(action, reason, obs)

    # ------------------------------------------------------------------
    def observe(self) -> Observation:
        """Snapshot the window, queues, and arrival deltas."""
        self.observations += 1
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
        self._scan_foreign_rebalances()
        routed = dict(self.fleet.router.routed)
        arrivals = {m: routed.get(m, 0) - self._last_routed.get(m, 0)
                    for m in routed}
        self._last_routed = routed
        total = self.window.stats()
        weights = {m.name: m.weight for m in self.fleet.members}
        wsum = sum(weights.values())
        if wsum > 0:
            weights = {k: v / wsum for k, v in weights.items()}
        return Observation(
            slot=self.fleet._slot,
            arrivals=arrivals,
            queued={m.name: m.engine.queued for m in self.fleet.members},
            window=self.window.by_model(),
            shed_rate=total["shed_rate"],
            weights=weights)

    def _scan_foreign_rebalances(self) -> None:
        """Start/refresh the cooldown when anyone else REBALANCEd.

        §12 recovery and the drift detector inject REBALANCE without
        asking the controller; racing them with another re-lease would
        thrash the pool.  Scanning the stream since the last observation
        catches every source, because every REBALANCE is a recorded
        instruction.
        """
        for r in reversed(self.fleet.executor.records):
            if r.seq < self._seen_seq:
                break
            if isinstance(r.instr, Rebalance):
                self._cooldown_left = self.cooldown
                break
        self._seen_seq = self.fleet.executor._seq.n

    # ------------------------------------------------------------------
    def decide(self, obs: Observation) -> list[tuple[Action, str]]:
        """Pure-ish decision step: observation -> (action, reason) list.

        Mutates only the controller's hysteresis state, never the fleet —
        lowering and injection happen in the caller.
        """
        out: list[tuple[Action, str]] = []
        out.extend(self._decide_reweight(obs))
        out.extend(self._decide_retune(obs))
        out.extend(self._decide_rebalance(obs))
        return out

    def _decide_reweight(self, obs: Observation) -> list[tuple[Action, str]]:
        mix = obs.mix()
        if not mix:
            return []
        tv = _tv(mix, obs.weights)
        if tv <= self.reweight_deadband:
            return []
        reason = (f"arrival mix TV distance {tv:.3f} > deadband "
                  f"{self.reweight_deadband} from weights")
        return [(Reweight(member=m.name,
                          weight=round(mix.get(m.name, 0.0), 6)), reason)
                for m in self.fleet.members]

    def _decide_retune(self, obs: Observation) -> list[tuple[Action, str]]:
        if self.slo_ms is None:
            return []
        out: list[tuple[Action, str]] = []
        lo, hi = self.band[0] * self.slo_ms, self.band[1] * self.slo_ms
        for m in self.fleet.members:
            width = getattr(m.engine, "group_size", None)
            if width is None or not hasattr(m.engine, "retune"):
                continue
            stats = obs.window.get(m.name)
            p95 = stats["p95_ms"] if stats else None
            if p95 is None:
                continue
            if p95 > hi:
                # still hot: keep narrowing, one halving per observation
                new = max(self.min_group, int(width) // 2)
                if new < width:
                    self._breached.add(m.name)
                    self._configured.setdefault(m.name, int(width))
                    out.append((
                        Retune(member=m.name, param="group_size",
                               value=new),
                        f"{m.name} p95 {p95:.1f}ms > {hi:.1f}ms "
                        f"({self.band[1]} * slo {self.slo_ms}ms): "
                        f"narrow fusion {width} -> {new}"))
            elif m.name in self._breached and p95 < lo:
                # recovered: widen one doubling per observation, back
                # toward the configured width; between the bands nothing
                # moves — the gap is the hysteresis
                target = self._configured.get(m.name, int(width))
                new = min(target, max(int(width) * 2, self.min_group))
                if new >= target:
                    self._breached.discard(m.name)
                if new > width:
                    out.append((
                        Retune(member=m.name, param="group_size",
                               value=new),
                        f"{m.name} p95 {p95:.1f}ms < {lo:.1f}ms "
                        f"({self.band[0]} * slo {self.slo_ms}ms): "
                        f"widen fusion {width} -> {new}"))
        return out

    def _decide_rebalance(self, obs: Observation) -> list[tuple[Action, str]]:
        if self.fleet.pool is None:
            return []
        if obs.shed_rate > self.shed_high:
            if self._shed_armed:
                self._shed_streak += 1
        elif obs.shed_rate < self.shed_low:
            self._shed_streak = 0
            self._shed_armed = True
        if (self._shed_streak < self.sustain or not self._shed_armed
                or self._cooldown_left > 0):
            return []
        mix = obs.mix() or obs.weights
        from repro_torch.fleet.planner import plan_fleet

        theta = plan_fleet(mix, max_evals=self.plan_evals).theta
        self._shed_streak = 0
        self._shed_armed = False    # re-arms only below shed_low
        self._cooldown_left = self.cooldown
        return [(RebalanceTheta(theta=round(theta, 6)),
                 f"shed rate {obs.shed_rate:.3f} > {self.shed_high} for "
                 f"{self.sustain} observations: re-lease at theta "
                 f"{theta:.4f} for mix {mix}")]

    # ------------------------------------------------------------------
    def _apply(self, action: Action, reason: str, obs: Observation) -> None:
        """Lower one action, inject it into the stream, log the decision
        at the injected instruction's seq watermark."""
        wm = self.fleet.executor._seq.n
        self.fleet.executor.inject(lower_action(action))
        # wall domain: replay has no controller — it re-executes the
        # *lowered* instructions, which the executor counts in slot domain
        self.fleet.executor.obs.counter(
            "control_decisions_total", "controller actions applied, by kind",
            "wall").inc(labels={"kind": action.kind,
                                "pool": self.fleet.executor.name})
        self.decisions.append(Decision(
            seq=wm, slot=self.fleet._slot, action=action, reason=reason,
            observed={"shed_rate": round(obs.shed_rate, 4),
                      "arrivals": dict(obs.arrivals),
                      "queued": dict(obs.queued)}))

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Controller summary merged into ``result().stats['control']``."""
        kinds: dict[str, int] = {}
        for d in self.decisions:
            kinds[d.action.kind] = kinds.get(d.action.kind, 0) + 1
        return {"interval": self.interval,
                "window": self.window.size,
                "observations": self.observations,
                "decisions": len(self.decisions),
                "by_kind": kinds}
