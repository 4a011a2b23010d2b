"""Chrome-tracing export of executed fleet instruction streams.

Converts :class:`~repro_torch.fleet.instructions.ExecRecord` streams into
the Chrome trace-event JSON format (the ``chrome://tracing`` / Perfetto
timeline): one *process* row per pool, one *thread* track per core within
it ('c-core', 'p-core'), a 'retire' track for FREEs, a 'control' track
for SEND/RECV/REBALANCE/SET_PARAM, and a 'bubbles' track marking every
core's idle gap of >= 1 slot inside the pool's active window — labeled
with what the idle core could have run next, so a pipeline bubble is a
named event.  The windows are the host's: a RUN slice spans the host's
enqueue of its launches, not their time on the card.

With a ``roofline`` model (``{pool: {member: roofline_fps}}``, see
:func:`roofline_model`) every RUN slice additionally carries
``achieved_fps`` (advances over the slice's wall window),
``roofline_fps`` (the member's latency-model advance-rate ceiling), and
``roofline_util`` — their ratio clamped to 1.05, since wall clocks on a
host are not the modelled FPGA's clock; the raw ratio is always
recoverable from the other two args.

Only executed records carry wall-clock stamps; compiled-only records
(``t0 is None``) are skipped and *counted* — the skip count comes back
from :func:`write_chrome_trace` so callers can report rather than
silently thin the timeline.  Timestamps are re-based to the earliest
``t0`` across every stream so the trace starts at 0.

Copy of ``repro/fleet/trace.py`` (the port imports nothing of ``repro``).
"""
from __future__ import annotations

import json
from typing import Mapping, Sequence

from repro_torch.fleet.instructions import (ExecRecord, Free, Rebalance,
                                            Recv, Run, Send, SetParam)

# track (tid) layout within each pool's process row; lower sorts first
_TRACKS = ("c-core", "p-core", "retire", "control", "bubbles")

#: clamp for the RUN-slice roofline utilization arg (host wall clocks
#: are not the board clock; see module docstring)
_UTIL_CLAMP = 1.05


def _track(instr) -> str:
    if isinstance(instr, Run):
        return {"c": "c-core", "p": "p-core"}.get(instr.core, "control")
    if isinstance(instr, Free):
        return "retire"
    return "control"


def _label(instr, advances: int) -> str:
    if isinstance(instr, Run):
        tag = " primary" if instr.primary else ""
        fused = " fused" if instr.fused else ""
        return f"RUN {instr.member} x{advances}{tag}{fused}"
    if isinstance(instr, Free):
        return f"FREE {instr.member}"
    if isinstance(instr, Send):
        whom = instr.member or "*"
        return f"SEND {whom} -> {instr.peer} x{advances}"
    if isinstance(instr, Recv):
        return f"RECV <- {instr.peer} x{advances}"
    if isinstance(instr, Rebalance):
        return f"REBALANCE theta={instr.theta:.2f}"
    if isinstance(instr, SetParam):
        return f"SET {instr.member}.{instr.param}={instr.value}"
    return type(instr).__name__


def roofline_model(obj) -> dict[str, dict[str, float]]:
    """``{pool: {member: roofline_fps}}`` from live engines.

    Accepts a ``MultiPoolRouter`` (walks ``.executors``, taking each
    pool executor's local fleet), one ``FleetEngine`` (one pool), or an
    already-shaped mapping (passed through).  A member's ceiling is the
    latency model's advance rate: one slot advances a stream one exec
    group, and a group costs at least ``min(group_latencies)`` cycles,
    so ``roofline_fps = freq_mhz * 1e6 / min(group_latencies)``.
    Members without a pipeline latency model (service stubs, opaque
    engines) are skipped — their RUN slices carry no roofline args.
    """
    executors = getattr(obj, "executors", None)
    if executors is not None:                       # MultiPoolRouter
        fleets = {name: ex.fleet for name, ex in executors.items()
                  if getattr(ex, "fleet", None) is not None}
    elif isinstance(obj, Mapping):
        return dict(obj)
    else:                                           # one FleetEngine
        fleets = {getattr(obj.executor, "name", "pool0"): obj}
    out: dict[str, dict[str, float]] = {}
    for pool, fleet in fleets.items():
        per: dict[str, float] = {}
        for m in getattr(fleet, "members", ()):
            runner = getattr(m.engine, "runner", None)
            if runner is None or not hasattr(runner, "plan"):
                continue
            sched = runner.plan.exec_schedule
            lats = list(sched.group_latencies)
            if not lats or min(lats) <= 0:
                continue
            per[m.name] = sched.board.freq_mhz * 1e6 / min(lats)
        if per:
            out[pool] = per
    return out


def host_enqueue_ms(records: Sequence[ExecRecord]) -> float:
    """Host time of the RUN instructions a fleet slot, in ms.  On a card
    a RUN only queues launches on the streams (the waits are in the
    FREEs), so this is the host's enqueue cost of one fleet step."""
    slots = {r.slot for r in records if r.t0 is not None}
    if not slots:
        return 0.0
    run_s = sum(r.t1 - r.t0 for r in records
                if isinstance(r.instr, Run) and r.t0 is not None)
    return run_s * 1e3 / len(slots)


def _bubbles(records: Sequence[ExecRecord]) -> list[dict]:
    """Idle-gap descriptors for one pool: for each core, every maximal
    run of >= 1 slot inside the pool's active slot range where that
    core ran nothing, stamped onto the per-slot wall windows."""
    slots = [r.slot for r in records]
    if not slots:
        return []
    lo, hi = min(slots), max(slots)
    # per-slot wall window across the whole pool (min t0, max t1)
    win: dict[int, list[float]] = {}
    for r in records:
        if r.t0 is None or r.t1 is None:
            continue
        w = win.setdefault(r.slot, [r.t0, r.t1])
        w[0] = min(w[0], r.t0)
        w[1] = max(w[1], r.t1)
    if not win:
        return []       # compiled-only: no wall clock to draw gaps on
    out: list[dict] = []
    for core in ("c", "p"):
        busy = {r.slot for r in records
                if isinstance(r.instr, Run) and r.instr.core == core}
        runs = sorted((r.slot, r.instr.member) for r in records
                      if isinstance(r.instr, Run) and r.instr.core == core)
        gap_start = None
        for slot in range(lo, hi + 2):          # hi+1 flushes a tail gap
            idle = slot <= hi and slot not in busy
            if idle and gap_start is None:
                gap_start = slot
            elif not idle and gap_start is not None:
                g0, g1 = gap_start, slot - 1
                gap_start = None
                nxt = next((m for s, m in runs if s > g1), None)
                could = (nxt if nxt is not None
                         else f"no {core}-core work")
                t0s = [win[s][0] for s in range(g0, g1 + 1) if s in win]
                t1s = [win[s][1] for s in range(g0, g1 + 1) if s in win]
                if t0s:
                    ts, te = min(t0s), max(t1s)
                else:       # a fully recordless gap: pin to neighbors
                    prev = [win[s][1] for s in win if s < g0]
                    after = [win[s][0] for s in win if s > g1]
                    ts = max(prev) if prev else 0.0
                    te = min(after) if after else ts
                out.append({"core": core, "slots": [g0, g1],
                            "could_have_run": could, "t0": ts, "t1": te})
    return out


def chrome_trace(streams: Mapping[str, Sequence[ExecRecord]], *,
                 roofline: Mapping[str, Mapping[str, float]] | None = None
                 ) -> dict:
    """``{pool name: records}`` -> a Chrome trace-event document.

    Every executed record becomes one complete ('X') event: ``ts``/``dur``
    in microseconds from the records' wall-clock window, filed under its
    pool's process and its core's thread, with slot / seq / advances
    in ``args`` for the details pane.  ``roofline`` adds per-RUN
    utilization args and is keyed like :func:`roofline_model`'s result.
    """
    stamped = [r for recs in streams.values() for r in recs
               if r.t0 is not None and r.t1 is not None]
    base = min((r.t0 for r in stamped), default=0.0)
    events: list[dict] = []
    for pid, (pool, records) in enumerate(sorted(streams.items())):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name",
                       "args": {"name": pool}})
        for tid, track in enumerate(_TRACKS):
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": track}})
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_sort_index",
                           "args": {"sort_index": tid}})
        pool_roof = (roofline or {}).get(pool, {})
        for r in records:
            if r.t0 is None or r.t1 is None:
                continue
            args = {"slot": r.slot, "seq": r.seq,
                    "advances": r.advances}
            if isinstance(r.instr, Run) and r.advances > 0 \
                    and r.t1 > r.t0:
                roof = pool_roof.get(r.instr.member)
                if roof:
                    achieved = r.advances / (r.t1 - r.t0)
                    args["achieved_fps"] = round(achieved, 3)
                    args["roofline_fps"] = round(roof, 3)
                    args["roofline_util"] = round(
                        min(achieved / roof, _UTIL_CLAMP), 6)
            events.append({
                "ph": "X",
                "pid": pid,
                "tid": _TRACKS.index(_track(r.instr)),
                "name": _label(r.instr, r.advances),
                "cat": r.instr.op,
                "ts": (r.t0 - base) * 1e6,
                # sub-resolution slices still need nonzero width to render
                "dur": max((r.t1 - r.t0) * 1e6, 0.05),
                "args": args,
            })
        for b in _bubbles(records):
            events.append({
                "ph": "X",
                "pid": pid,
                "tid": _TRACKS.index("bubbles"),
                "name": (f"bubble {b['core']}-core "
                         f"x{b['slots'][1] - b['slots'][0] + 1}"),
                "cat": "bubble",
                "ts": (b["t0"] - base) * 1e6,
                "dur": max((b["t1"] - b["t0"]) * 1e6, 0.05),
                "args": {"core": b["core"], "slots": b["slots"],
                         "could_have_run": b["could_have_run"]},
            })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(streams: Mapping[str, Sequence[ExecRecord]],
                       path: str, *,
                       roofline: Mapping[str, Mapping[str, float]] |
                       None = None) -> tuple[int, int]:
    """Write :func:`chrome_trace` to ``path``; returns ``(events,
    skipped)`` — the event count and how many compiled-only (unstamped)
    records the export had to leave out."""
    doc = chrome_trace(streams, roofline=roofline)
    skipped = sum(1 for recs in streams.values() for r in recs
                  if r.t0 is None or r.t1 is None)
    with open(path, "w") as f:
        json.dump(doc, f)
    return len(doc["traceEvents"]), skipped
