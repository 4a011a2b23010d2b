"""Readings of the engine's spans and counters over a window.

The span readings take the :class:`~repro_torch.obs.spans.Span` list a
:class:`~repro_torch.obs.SpanRecorder` handed out and a window ``[t0, t1]``
in ns on ``time.time_ns()``; the counter readings take two
:meth:`~repro_torch.obs.Registry.snapshot` dicts taken at its edges.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.obs.spans import Span


def _inside(spans: Sequence[Span], name: str, t0: int, t1: int
            ) -> list[Span]:
    return [s for s in spans
            if s.name == name and t0 <= s.start_ns and s.end_ns <= t1]


def advance_ms(spans: Sequence[Span], t0: int, t1: int) -> float | None:
    """Mean ``engine.advance`` span in ms over the slots inside the window
    (None if none is)."""
    adv = _inside(spans, "engine.advance", t0, t1)
    if not adv:
        return None
    return sum(s.duration_ns for s in adv) / len(adv) / 1e6


def ready_wait_ms(spans: Sequence[Span], t0: int, t1: int) -> float | None:
    """``engine.ready_wait`` ms of a slot, summed within its
    ``engine.retire``, mean over the retirements inside the window (None
    if none is)."""
    retire = _inside(spans, "engine.retire", t0, t1)
    if not retire:
        return None
    wait = {s.sid: 0 for s in retire}
    for s in spans:
        if s.name == "engine.ready_wait" and s.parent in wait:
            wait[s.parent] += s.duration_ns
    return sum(wait.values()) / len(wait) / 1e6


def growth(before: dict, after: dict, name: str) -> float | None:
    """The counter ``name``'s growth between two registry snapshots, over
    all its series (None if the later snapshot lacks it)."""
    def total(snap: dict) -> float | None:
        entry = snap.get("counters", {}).get(name)
        return None if entry is None else sum(entry["series"].values())

    a, b = total(before), total(after)
    return None if b is None else b - (a or 0)


def per_kreq(before: dict, after: dict, name: str,
             requests: int) -> float | None:
    """The counter ``name``'s :func:`growth` per 1000 ``requests`` (None
    without requests or without the counter)."""
    n = growth(before, after, name)
    if n is None or requests <= 0:
        return None
    return n / requests * 1000
